"""Multipass PIV's window deformation (``ops/multipass.deformed_pairs``) against the JAX package on the CPU.

On a CPU tensor the wrapper takes its plain version (``_deformed_pairs``);
its pairs are held to JAX's jitted ``_deform_stage`` (``a_k``, ``b_k``)
within 1e-5 * 255, the tolerance of the module test in
``tests/test_torch_multipass.py``, and bit for bit, on inputs made with numpy
from seeds (``test_torch_cuda.DEFORM_CASES``): odd non-square frames, one-row
and one-column predictor grids, a predictor that samples past all four edges,
more pairs than one plain block, frames 300 px across and a 13 px grid step.
The bits pin three rewrites of XLA's CPU build (jax 0.9.0) that the port
reproduces: the dense predictor's coordinates multiplied by the step's
float32 reciprocal (JAX divides by a constant), and the bilinear sums
contracted into fused multiply-adds, chain A in the dense predictor and
chain B in the frame samples (``ops/interp.map_linear``). The kernel's own
code is held to the plain version bit for bit on the same cases in
``tests/test_torch_kernel_emulation.py``, and on the card in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import pyorc_tpu_torch
from pyorc_tpu.ops import multipass as jmp
from pyorc_tpu_torch.ops import multipass as tmp
from pyorc_tpu_torch.ops import piv_kernels
from pyorc_tpu_torch.ops import windows as win

from test_torch_cuda import DEFORM_CASES, _frames, deform_inputs


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


@pytest.mark.parametrize("case", list(DEFORM_CASES))
def test_deformed_pairs_match_jax(case, monkeypatch):
    frames, u, v, rows, cols, block_px = deform_inputs(case)
    n_pairs, h, w = frames.shape[0] - 1, frames.shape[1], frames.shape[2]
    if block_px:
        monkeypatch.setattr(tmp, "_DEFORM_BLOCK_PX", block_px)
    blocks = []
    deform_pair = tmp._deform_pair
    monkeypatch.setattr(tmp, "_deform_pair", lambda a, *rest: blocks.append(a.shape[0]) or deform_pair(a, *rest))
    before = dict(piv_kernels.LAUNCHES)
    got = tmp.deformed_pairs(*(torch.as_tensor(x) for x in (frames, u, v)), rows, cols).numpy()
    assert piv_kernels.KERNEL_ROUTE["deform_pairs"] == "plain_cpu" and piv_kernels.LAUNCHES == before
    assert got.shape == (2 * n_pairs, h, w) and np.isfinite(got).all()
    assert blocks == ([2, 2, 1] if block_px else [n_pairs])
    if case == "past-all-edges":
        dr = tmp._grid_to_dense(-torch.as_tensor(v), rows, cols, h, w).numpy()
        dc = tmp._grid_to_dense(torch.as_tensor(u), rows, cols, h, w).numpy()
        y, x = np.mgrid[0:h, 0:w].astype(np.float32)
        for r, c in ((y - dr / 2, x - dc / 2), (y + dr / 2, x + dc / 2)):
            assert r.min() < -10 and r.max() > h + 9 and c.min() < -10 and c.max() > w + 9
    grid = tuple(map(float, rows)), tuple(map(float, cols))
    a_k, b_k, _, _ = jmp._deform_stage(frames[:-1], frames[1:], u, v, *grid, *grid)
    np.testing.assert_allclose(got[0::2], np.asarray(a_k), atol=1e-5 * 255, rtol=0)
    np.testing.assert_allclose(got[1::2], np.asarray(b_k), atol=1e-5 * 255, rtol=0)
    assert np.array_equal(got[0::2].view(np.int32), np.asarray(a_k).view(np.int32))
    assert np.array_equal(got[1::2].view(np.int32), np.asarray(b_k).view(np.int32))


def test_deformed_pairs_check_their_inputs():
    frames, u, v, rows, cols, _ = deform_inputs("odd-non-square")
    f, ut, vt = (torch.as_tensor(x) for x in (frames, u, v))
    bad = {
        "frames must be \\[T, H, W\\]": (f[0], ut, vt, rows, cols),
        "frames must be contiguous float32": (f.to(torch.float64), ut, vt, rows, cols),
        "u must be contiguous float32": (f, ut.transpose(1, 2).contiguous().transpose(1, 2), vt, rows, cols),
        "v must be \\[T - 1, n_rows, n_cols\\]": (f, ut, vt[1:], rows, cols),
        "u must be \\[T - 1, n_rows, n_cols\\]": (f, ut, vt, rows[1:], cols),
    }
    for message, args in bad.items():
        with pytest.raises(ValueError, match=message):
            tmp.deformed_pairs(*args)


def test_piv_multipass_deforms_through_the_wrapper(monkeypatch):
    """Every pass after the first deforms the whole float32 stack through ``deformed_pairs``, on the
    previous pass's grid, and the correlation gets exactly those pairs."""
    calls, deformed, correlated = [], [], []
    wrapper, routed = tmp.deformed_pairs, piv_kernels.piv_pairs_routed

    def deform(frames, u, v, rows_prev, cols_prev):
        calls.append((frames, u.shape, len(rows_prev), len(cols_prev)))
        deformed.append(wrapper(frames, u, v, rows_prev, cols_prev))
        return deformed[-1]

    def correlate(pairs, *args, **kwargs):
        correlated.append(pairs)
        return routed(pairs, *args, **kwargs)

    monkeypatch.setattr(tmp, "deformed_pairs", deform)
    monkeypatch.setattr(piv_kernels, "piv_pairs_routed", correlate)
    stack = torch.as_tensor(_frames(np.random.default_rng(4), 4, 96, 128))
    args = ((96, 128), (16, 16), (8, 8), *win.get_field_shape((96, 128), (16, 16), (8, 8)))
    tmp.piv_multipass(stack, *args, passes=3)
    assert [c[1:] for c in calls] == [((3, 2, 3), 2, 3), ((3, 5, 7), 5, 7)]  # the 64 and 32 px grids
    assert all(c[0].dtype == torch.float32 and torch.equal(c[0], stack.float()) for c in calls)
    assert piv_kernels.KERNEL_ROUTE["deform_pairs"] == "plain_cpu"
    assert len(correlated) == 3 and correlated[0].shape == (6, 96, 128)
    assert len(deformed) == 2 and all(c is d for c, d in zip(correlated[1:], deformed))


def test_chip_smoke_deform_checks_on_cpu():
    """chip_smoke's deformation checks rehearsed on the CPU: the launch rule (``passes - 1`` a call of
    the cascade, route "cuda"), the multipass engine-chunks check and one deformed pass's check."""
    import chip_smoke

    assert chip_smoke.check_deform_launches("ok", 4, 6, 3, "cuda") == 2
    for launches, route in ((3, "cuda"), (4, "plain_cpu"), (0, "cuda")):
        with pytest.raises(AssertionError, match="deformation launches"):
            chip_smoke.check_deform_launches("bad", launches, 6, 3, route)
    cc = chip_smoke.nadir_camera_config(480, 640)  # projected 280 x 440: room for the 128 px pass
    stack = chip_smoke.advected_stack(480, 640, 5, "cpu")
    proj = chip_smoke.frames_dataarray(stack, cc).frames.normalize(samples=5).frames.project()
    whole = proj.frames.get_piv(window_size=32, overlap=(16, 16), passes=3)
    out = chip_smoke.multipass_chunks_check(proj, whole, chunksize=3)
    assert out == {"chunksize": 3, "launches": 0, "deform_launches": 0, "deform_route": "plain_cpu"}
    frames, u, v, rows, cols, _ = deform_inputs("one-row-grid")
    row = chip_smoke.deform_check(*(torch.as_tensor(x) for x in (frames, u, v)), rows, cols, "one row", "cpu")
    assert row["bitwise"] and row["max_abs_err"] == 0.0 and row["grid"] == [1, 11] and row["bound_by"] == "bytes"


def test_deform_bound_at_1080p_is_set_by_bytes():
    """The deformation's yardstick on the 1080p slice's shape (126 x 880 x 1720, the predictor on the
    64 px grid at 32 px steps), from shapes alone: 0.680 ms, set by bytes (2.28 GB at 3.35 TB/s); its
    62 float32 instructions a pair pixel (12 of them the fused multiply-adds of JAX's rounding order)
    take 0.350 ms at half the fp32 peak."""
    from pyorc_tpu_torch.ops import roofline

    n_rows, n_cols = win.get_field_shape((880, 1720), (64, 64), (32, 32))
    frames = torch.empty((126, 880, 1720), device="meta")
    u = torch.empty((125, n_rows, n_cols), device="meta")
    bound_ms, bound_by = roofline.deform_bound(frames, u)
    assert (n_rows, n_cols) == (26, 52) and bound_by == "bytes"
    assert bound_ms == pytest.approx(0.6799, abs=1e-4)
    assert roofline.DEFORM_PEAK_FLOPS == roofline.PEAK_FP32_FLOPS / 2
    ops_ms = 1e3 * roofline.DEFORM_OPS_PER_PIXEL * 125 * 880 * 1720 / roofline.DEFORM_PEAK_FLOPS
    assert ops_ms == pytest.approx(0.3501, abs=1e-4) and ops_ms < bound_ms


@pytest.mark.parametrize("kind, shape, w_px, want_ms", [
    # chip_smoke's kernel phase: 9 uint8 frames of 1088x1920 at 16 px, 8 consecutive pairs
    ("pairs", (9, 1088, 1920), 16, 0.052148),
    # the 4K ensemble slice's projected stack (2160x3840 projected to 1560 x 3240, 47 x 100 windows), 299 pairs
    ("ensemble", (300, 1560, 3240), 64, 6.109239),
])
def test_piv_bounds_are_set_by_operations(kind, shape, w_px, want_ms):
    """The PIV kernels' yardsticks from shapes alone: the FFT algorithm's operations at the fp32 peak,
    not the bytes, set the per-pair kernel's bound at 16 px and the ensemble kernel's at 64 px."""
    import chip_smoke
    from pyorc_tpu_torch.ops import roofline

    frames = torch.empty(shape, dtype=torch.uint8, device="meta")
    args = chip_smoke._grid(shape[1:], w_px)
    bound = roofline.pairs_bound if kind == "pairs" else roofline.ensemble_bound
    bound_ms, bound_by = bound(frames, args)
    assert bound_by == "operations"
    assert bound_ms == pytest.approx(want_ms, abs=1e-6)


SASS_LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_119deform_pairs_kernelEPKfiiiS1_S1_iiS1_S1_PfPy
	.headerflags	@"EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                         /* 0x00000a00ff017b82 */
                                                                                  /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                             /* 0x0000000000007919 */
        /*0020*/                   LDS R2, [R3] ;                                 /* 0x00000a00ff017b82 */
.L_x_0:
        /*0030*/                   FADD R2, R2, R3 ;                              /* 0x00000a00ff017b82 */
        /*0040*/                   LDS R4, [R3+0x4] ;                             /* 0x00000a00ff017b82 */
        /*0050*/                   STG.E desc[UR4][R4.64], R2 ;                   /* 0x00000a00ff017b82 */
        /*0060*/                   STG.E desc[UR4][R6.64], R2 ;                   /* 0x00000a00ff017b82 */
        /*0070*/              @!P0 BRA `(.L_x_0) ;                                /* 0x00000a00ff017b82 */
        /*0080*/                   LDG.E R5, desc[UR4][R8.64] ;                   /* 0x00000a00ff017b82 */
        /*0090*/                   STG.E desc[UR4][R4.64], R5 ;                   /* 0x00000a00ff017b82 */
        /*00a0*/              @P1 BRA 0x20 ;                                      /* 0x00000a00ff017b82 */
        /*00b0*/                   EXIT ;                                         /* 0x00000a00ff017b82 */
        /*00c0*/                   BRA 0xc0;                                      /* 0x00000a00ff017b82 */
        /*00d0*/                   NOP;                                           /* 0x00000a00ff017b82 */
		Function : _Z5otherPf
        /*0000*/                   STG.E desc[UR4][R4.64], R2 ;                   /* 0x00000a00ff017b82 */
        /*0010*/                   BRA 0x0;                                       /* 0x00000a00ff017b82 */
"""


def test_chip_smoke_sass_loops():
    """chip_smoke's SASS count: only the named kernel; loops from backward branches to labels or
    addresses, the innermost storing one (the outer loop holds it; the self-branch at the end stores
    nothing), its stores, shared and global loads, and instructions a pair pixel (two stores each)."""
    import chip_smoke

    (got,) = chip_smoke.sass_loops(SASS_LISTING)
    assert got == {"function_instructions": 13, "store_loops": [
        {"instructions": 5, "stores": 2, "shared_loads": 1, "global_loads": 0, "per_pair_pixel": 5.0}]}
