"""The CUDA kernels against their plain versions on the card (skipped without one).

Run on a GPU machine with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from pyorc_tpu_torch.ops import piv as piv_ops
from pyorc_tpu_torch.ops import piv_kernels
from pyorc_tpu_torch.ops import windows as win

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _frames(rng, n_frames, h, w, zero_band=False, dtype=np.uint8):
    from scipy.ndimage import gaussian_filter, shift

    base = gaussian_filter(rng.uniform(0, 1, (h, w)) ** 8, 1.2, mode="wrap")
    base = base / base.max() * 220 + 20
    stack = np.stack([shift(base, (-1.4 * i, 2.3 * i), order=3, mode="wrap") for i in range(n_frames)])
    if zero_band:
        stack[:, h // 2 :, :] = 0
    return np.clip(stack, 0, 255).astype(dtype)


def _compare(out_k, out_p, gap):
    """NaN masks equal, |dcmax| <= 1e-4, s2n within 1e-3 relative, and u/v
    within 1e-3 px where the top-2 peak gap exceeds 5e-3."""
    for a, b in zip(out_k, out_p):
        assert a.shape == b.shape
        assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.nan_to_num((out_k[2] - out_p[2]).abs()).max() <= 1e-4
    assert torch.nan_to_num((out_k[3] - out_p[3]).abs() / out_p[3].abs().clamp(min=1e-6)).max() <= 1e-3
    confident = (gap > 5e-3) & ~torch.isnan(out_p[0])
    for a, b in zip(out_k[:2], out_p[:2]):
        assert (a - b).abs()[confident].max() <= 1e-3


def _gap(frames, dims, sas, overlap, pair_stride, shape):
    return piv_ops.top2_gap(frames, dims, sas, overlap, pair_stride).reshape(shape)


# every class of the transform's plan: powers of two, 2^a * 13, other odd parts up to 15, odd parts over 15
@pytest.mark.parametrize("size", [8, 12, 13, 14, 16, 17, 22, 24, 26, 32, 40, 48, 52, 64, 66, 72, 75, 96, 104, 120, 127, 128])
@pytest.mark.parametrize("pair_stride", [1, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_kernel_matches_plain(cuda, size, pair_stride, dtype):
    rng = np.random.default_rng(size)
    h, w = 4 * size + 20, 6 * size + 8
    frames = torch.as_tensor(_frames(rng, 6, h, w, zero_band=size == 32, dtype=dtype), device=cuda)
    sas, overlap = (size, size), (size // 2, size // 2)
    n_rows, n_cols = win.get_field_shape((h, w), sas, overlap)
    args = ((h, w), sas, overlap, n_rows, n_cols)
    before = piv_kernels.LAUNCHES["piv_pairs"]
    out_k = piv_kernels.piv_pairs_fused(frames, *args, pair_stride=pair_stride)
    assert piv_kernels.LAUNCHES["piv_pairs"] == before + 1
    assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "cuda"
    out_p = piv_kernels.piv_pairs_fused_plain(frames, *args, pair_stride=pair_stride)
    torch.cuda.synchronize()
    _compare(out_k, out_p, _gap(frames, (h, w), sas, overlap, pair_stride, out_p[0].shape))


def test_kernel_signal_threshold(cuda):
    rng = np.random.default_rng(1)
    h, w = 96, 128
    stack = _frames(rng, 3, h, w)
    stack[:, :40, :48] = 0
    stack[1, 40:72, 48:80] = 0
    frames = torch.as_tensor(stack, device=cuda)
    sas, overlap = (16, 16), (8, 8)
    n_rows, n_cols = win.get_field_shape((h, w), sas, overlap)
    args = ((h, w), sas, overlap, n_rows, n_cols, 0.5)
    out_k = piv_kernels.piv_pairs_fused(frames, *args)
    out_p = piv_kernels.piv_pairs_fused_plain(frames, *args)
    assert torch.isnan(out_k[2]).any()
    _compare(out_k, out_p, _gap(frames, (h, w), sas, overlap, 1, out_p[0].shape))


@pytest.mark.parametrize("sas", [(64, 128), (128, 64), (32, 64), (16, 40), (72, 24), (75, 66), (26, 64), (75, 64), (128, 66)])
@pytest.mark.parametrize("pair_stride", [1, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_kernel_matches_plain_non_square(cuda, sas, pair_stride, dtype):
    """Non-square windows, the FFT and the table DFT mixed per axis among them, 50 % overlap."""
    wy, wx = sas
    rng = np.random.default_rng(wy * 1000 + wx)
    h, w = 4 * wy + 20, 5 * wx + 8
    frames = torch.as_tensor(_frames(rng, 6, h, w, zero_band=sas == (32, 64), dtype=dtype), device=cuda)
    overlap = (wy // 2, wx // 2)
    n_rows, n_cols = win.get_field_shape((h, w), sas, overlap)
    args = ((h, w), sas, overlap, n_rows, n_cols)
    before = piv_kernels.LAUNCHES["piv_pairs"]
    out_k = piv_kernels.piv_pairs_fused(frames, *args, pair_stride=pair_stride)
    assert piv_kernels.LAUNCHES["piv_pairs"] == before + 1
    assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "cuda"
    out_p = piv_kernels.piv_pairs_fused_plain(frames, *args, pair_stride=pair_stride)
    torch.cuda.synchronize()
    _compare(out_k, out_p, _gap(frames, (h, w), sas, overlap, pair_stride, out_p[0].shape))


def test_kernel_raises_on_unsupported_geometry(cuda):
    frames = torch.zeros((3, 300, 300), device=cuda)
    for sas in ((130, 130), (6, 6), (136, 64)):
        overlap = (sas[0] // 2, sas[1] // 2)
        n_rows, n_cols = win.get_field_shape((300, 300), sas, overlap)
        before = piv_kernels.LAUNCHES["piv_pairs"]
        with pytest.raises(ValueError, match="sides of 8-128 px.*ROADMAP.md, queue B"):
            piv_kernels.piv_pairs_fused(frames, (300, 300), sas, overlap, n_rows, n_cols)
        assert piv_kernels.LAUNCHES["piv_pairs"] == before


def _compare_ensemble(out_k, out_p, corr_min):
    """Gates equal (no pair of these frames lies at a threshold), |d corr_sum| <=
    1e-4 * max(count, 1), counts equal, |d cmax| <= 1e-4, s2n within 1e-3 relative."""
    (sum_k, n_k, c_k, s_k), (sum_p, n_p, c_p, s_p) = out_k, out_p
    for a, b in zip(out_k, out_p):
        assert a.shape == b.shape and torch.isfinite(a).all()
    assert torch.equal(c_k > 0, c_p > 0) and torch.equal(n_k, n_p)
    assert ((sum_k - sum_p).abs().flatten(1).amax(1) <= 1e-4 * n_p.clamp(min=1)).all()
    assert (c_k - c_p).abs().max() <= 1e-4
    assert ((s_k - s_p).abs() / s_p.clamp(min=1e-6)).max() <= 1e-3


@pytest.mark.parametrize(
    "size,step",
    [
        (8, 4), (16, 8), (26, 13), (32, 16), (32, 12), (64, 32), (75, 37), (104, 52), (128, 64),
        (12, 6), (13, 6), (17, 8), (24, 12), (40, 20), (48, 24), (52, 26), (66, 33), (96, 48), (127, 63), (14, 7), (22, 11), (72, 36), (120, 60),
        ((64, 128), (32, 64)), ((16, 40), (8, 12)), ((128, 72), (40, 36)),
        ((26, 64), (13, 32)), ((75, 64), (37, 32)), ((128, 66), (64, 33)),
    ],
    ids=lambda v: "x".join(map(str, win._as2(v))),
)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("n_frames", [7, 8], ids=["6-pairs", "7-pairs"])
def test_ensemble_kernel_matches_plain(cuda, size, step, dtype, n_frames):
    """Every class of side of 8-128 px, square and not, with an even and an odd number of pairs."""
    sas, steps = win._as2(size), win._as2(step)
    rng = np.random.default_rng(sas[0] + sas[1] + steps[0])
    h, w = 4 * sas[0] + 20, 6 * sas[1] + 8
    frames = torch.as_tensor(_frames(rng, n_frames, h, w, zero_band=sas[0] == 32, dtype=dtype), device=cuda)
    overlap = (sas[0] - steps[0], sas[1] - steps[1])
    n_rows, n_cols = win.get_field_shape((h, w), sas, overlap)
    args = ((h, w), sas, overlap, n_rows, n_cols, 0.1, 1.5)
    before = piv_kernels.LAUNCHES["piv_ensemble"]
    out_k = piv_kernels.piv_ensemble_fused(frames, *args)
    assert piv_kernels.LAUNCHES["piv_ensemble"] == before + 1
    assert piv_kernels.KERNEL_ROUTE["piv_ensemble_fused"] == "cuda"
    out_p = piv_kernels.piv_ensemble_fused_plain(frames, *args)
    torch.cuda.synchronize()
    assert (out_p[1] > 0).any()
    _compare_ensemble(out_k, out_p, 0.1)


def test_ensemble_kernel_signal_threshold(cuda):
    rng = np.random.default_rng(2)
    h, w = 96, 128
    stack = _frames(rng, 4, h, w)
    stack[:, :40, :48] = 0
    stack[1, 40:72, 48:80] = 0
    frames = torch.as_tensor(stack, device=cuda)
    sas, overlap = (16, 16), (8, 8)
    n_rows, n_cols = win.get_field_shape((h, w), sas, overlap)
    args = ((h, w), sas, overlap, n_rows, n_cols, 0.1, 1.5, 0.5)
    out_k = piv_kernels.piv_ensemble_fused(frames, *args)
    out_p = piv_kernels.piv_ensemble_fused_plain(frames, *args)
    assert (out_p[1] == 0).any() and (out_p[1] > 0).any()
    _compare_ensemble(out_k, out_p, 0.1)


@pytest.mark.parametrize("count_min", [0.2, 0.5])
def test_ensemble_finish_on_the_card_matches_the_cpu(cuda, count_min):
    """The engine's ensemble finish on the kernel's results on the card against the same finish on their CPU
    copies (the sums in another order, the card's ``logf``): NaN masks equal, corr and s2n within 1e-6 relative,
    u and v within 1e-5 px. A band dark in 25 of 41 frames leaves its windows 15 of 40 ok pairs."""
    from pyorc_tpu_torch.velocimetry import engine

    rng = np.random.default_rng(25)
    h, w = 4 * 64 + 20, 6 * 64 + 8
    stack = _frames(rng, 41, h, w)
    stack[:25, : h // 3, :] = 0
    sas, overlap = (64, 64), (32, 32)
    n_rows, n_cols = win.get_field_shape((h, w), sas, overlap)
    out = piv_kernels.piv_ensemble_fused(torch.as_tensor(stack, device=cuda), (h, w), sas, overlap, n_rows, n_cols)
    assert piv_kernels.KERNEL_ROUTE["piv_ensemble_fused"] == "cuda"
    args = (count_min, stack.shape[0] - 1, n_rows, n_cols)
    got = engine._ensemble_finish(*out, *args)
    assert got.device.type == "cuda"
    got = got.cpu().numpy()
    want = engine._ensemble_finish(*(t.cpu() for t in out), *args).numpy()
    assert np.isnan(want[0]).any() == (count_min == 0.5) and np.isfinite(want[0]).any()
    for name, g, x in zip(("u", "v", "corr", "s2n"), got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(x), err_msg=name)
        if name in ("u", "v"):
            np.testing.assert_allclose(g, x, rtol=0, atol=1e-5, equal_nan=True, err_msg=name)
        else:
            np.testing.assert_allclose(g, x, rtol=1e-6, atol=0, equal_nan=True, err_msg=name)


def test_ensemble_kernel_raises_on_unsupported_geometry(cuda):
    frames = torch.zeros((3, 300, 300), device=cuda)
    for sas in ((130, 130), (6, 6), (136, 64)):
        overlap = (sas[0] // 2, sas[1] // 2)
        n_rows, n_cols = win.get_field_shape((300, 300), sas, overlap)
        before = piv_kernels.LAUNCHES["piv_ensemble"]
        with pytest.raises(ValueError, match="sides of 8-128 px.*ROADMAP.md, queue B"):
            piv_kernels.piv_ensemble_fused(frames, (300, 300), sas, overlap, n_rows, n_cols)
        assert piv_kernels.LAUNCHES["piv_ensemble"] == before


def test_copies_are_counted_where_they_happen(cuda):
    """A tensor already on the card is neither copied nor counted, whether the card is named
    "cuda" or "cuda:0"; a pinned upload of a strided host view equals it and counts its bytes."""
    from pyorc_tpu_torch import _device

    host = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    view = host[:, 1:, 1:]
    before = _device.COPY_BYTES["h2d"]
    on_card = _device.to_device(host, cuda)
    assert _device.to_device(on_card, cuda) is on_card
    assert _device.to_device(on_card, "cuda:0") is on_card
    up = _device.PinnedUploader(cuda).upload(view)
    torch.cuda.synchronize()
    assert torch.equal(up.cpu(), torch.as_tensor(np.ascontiguousarray(view)))
    assert _device.COPY_BYTES["h2d"] - before == host.nbytes + view.nbytes


# ------------------------------------------------------------ multipass deformation
# Cases of ops/multipass.deformed_pairs, shared with the CPU tests (tests/test_torch_deform.py against
# JAX, tests/test_torch_kernel_emulation.py for the kernel's code): (frames, h, w, window, step) of the
# predictor's grid, the predictor's spread [px], pixels of one plain block (None: the default), and
# cells of the grid's first row set to 12 px, past the kernel's staged halo (4 px: |u| < 7.99).
DEFORM_CASES = {
    "odd-non-square": (5, 45, 77, (16, 16), (8, 8), 3.0, None, 0),
    "one-row-grid": (4, 30, 96, (24, 16), (12, 8), 3.0, None, 0),  # one grid row: _grid_coords' step 1.0
    "one-column-grid": (4, 96, 30, (16, 24), (8, 12), 3.0, None, 0),
    "past-all-edges": (4, 40, 60, (16, 16), (8, 8), 50.0, None, 0),  # samples up to ~25 px off every edge
    "over-one-block": (6, 24, 32, (16, 16), (8, 8), 3.0, 2 * 24 * 32, 0),  # 5 pairs in plain blocks of 2
    "small-spread": (5, 45, 77, (16, 16), (8, 8), 0.5, None, 0),  # every tap within the staged halo
    # three tiles down and across, the first row's past the halo; 300 px across, where one float32 ulp
    # of a sample coordinate (3e-5 px) times 0-255 noise would pass the JAX test's 1e-5 * 255: the
    # rounding orders must be JAX's own
    "some-cells-past-halo": (4, 70, 300, (16, 16), (8, 8), 0.5, None, 3),
    # a step of 13 px, whose float32 reciprocal (XLA's rewrite of JAX's division) rounds the dense
    # predictor's coordinates other than a division would
    "step-13-px": (4, 300, 300, (26, 26), (13, 13), 3.0, None, 0),
    "run-remainder": (19, 24, 40, (16, 16), (8, 8), 0.5, None, 0),  # 18 pairs: runs of 12 and of 6
    "ragged-width": (3, 41, 263, (16, 16), (8, 8), 0.5, None, 0),  # a width past two tiles, not a multiple of 4
    "below-one-tile": (3, 20, 30, (8, 8), (4, 4), 0.5, None, 0),  # a plane smaller than one tile
}
DEFORM_CARD_CASE = (9, 880, 1720, (64, 64), (32, 32), 3.0, None, 0)  # the 1080p slice's projected frames, 64 px pass


def deform_inputs(case):
    """(frames [T, H, W], u, v [T - 1, n_rows, n_cols], rows, cols, plain block px) of ``case`` (a key of
    DEFORM_CASES, or DEFORM_CARD_CASE), numpy float32 made from a seed. ``past-all-edges`` takes a
    predictor of alternating sign around its spread, so samples leave the frame on all four sides."""
    n_frames, h, w, window, step, spread, block_px, far = DEFORM_CASES.get(case, case)
    rng = np.random.default_rng(n_frames * 1000 + h + w)
    frames = rng.uniform(0, 255, (n_frames, h, w)).astype(np.float32)
    cols, rows = win.get_rect_coordinates((h, w), window, window, (window[0] - step[0], window[1] - step[1]))
    shape = (n_frames - 1, len(rows), len(cols))
    if spread > 10:
        signs = np.where((np.arange(shape[1])[:, None] + np.arange(shape[2])[None, :]) % 2, 1.0, -1.0)
        u, v = (spread * signs * rng.uniform(0.8, 1.2, shape) * s for s in (1, -1))
    else:
        u, v = rng.normal(2.3, spread, shape), rng.normal(-1.4, spread, shape)
    u[:, 0, :far] = 12.0
    return frames, u.astype(np.float32), v.astype(np.float32), rows, cols, block_px


def check_halo_misses(case, misses, geometry):
    """Assert the kernel's count of (tile, pair)s past its staged halo in one launch of ``case``: none on
    a small spread, all past every edge, some where a few cells pass it (a spread of 3 px: not asserted)."""
    n_frames, h, w, _, _, spread, _, far = DEFORM_CASES[case]
    total = -(-h // geometry["tile_rows"]) * -(-w // geometry["tile_cols"]) * (n_frames - 1)
    if spread > 10:
        assert misses == total
    elif far:
        assert 0 < misses < total
    elif spread < 1:
        assert misses == 0


def test_deform_kernel_bitwise_plain_at_1080p(cuda):
    """The kernel's pairs equal the plain version's on the card bit for bit: 9 frames of 880x1720 (the
    1080p slice's projected frames) deformed by a predictor on the 64 px grid."""
    from pyorc_tpu_torch.ops import multipass

    frames, u, v, rows, cols, _ = deform_inputs(DEFORM_CARD_CASE)
    f, ut, vt = (torch.as_tensor(x, device=cuda) for x in (frames, u, v))
    before = piv_kernels.LAUNCHES["deform_pairs"]
    got = multipass.deformed_pairs(f, ut, vt, rows, cols)
    assert piv_kernels.LAUNCHES["deform_pairs"] == before + 1
    assert piv_kernels.KERNEL_ROUTE["deform_pairs"] == "cuda"
    coords = multipass._dense_coords(rows, cols, *frames.shape[1:], cuda)
    want = multipass._deformed_pairs(f, ut, vt, rows, cols, coords)
    torch.cuda.synchronize()
    assert got.shape == (16, 880, 1720)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", list(DEFORM_CASES))
def test_deform_kernel_cases_bitwise_plain(cuda, case):
    """Every shared case on the card: the kernel's pairs bit for bit the plain version's, one launch, and
    the (tile, pair)s past the staged halo counted as under the g++ emulation."""
    from pyorc_tpu_torch.ops import multipass

    frames, u, v, rows, cols, _ = deform_inputs(case)
    f, ut, vt = (torch.as_tensor(x, device=cuda) for x in (frames, u, v))
    before, misses = piv_kernels.LAUNCHES["deform_pairs"], multipass.deform_halo_misses(cuda)
    got = multipass.deformed_pairs(f, ut, vt, rows, cols)
    assert piv_kernels.LAUNCHES["deform_pairs"] == before + 1
    check_halo_misses(case, multipass.deform_halo_misses(cuda) - misses, multipass.deform_geometry())
    coords = multipass._dense_coords(rows, cols, *frames.shape[1:], cuda)
    want = multipass._deformed_pairs(f, ut, vt, rows, cols, coords)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_deform_cuda_tensor_never_takes_the_plain_route(cuda, monkeypatch):
    """On a CUDA tensor the wrapper and piv_multipass launch the kernel, never the plain version."""
    from pyorc_tpu_torch.ops import multipass

    def refuse(*args, **kwargs):
        raise AssertionError("the plain deformation ran on a CUDA tensor")

    monkeypatch.setattr(multipass, "_deformed_pairs", refuse)
    frames, u, v, rows, cols, _ = deform_inputs("odd-non-square")
    f, ut, vt = (torch.as_tensor(x, device=cuda) for x in (frames, u, v))
    before = piv_kernels.LAUNCHES["deform_pairs"]
    multipass.deformed_pairs(f, ut, vt, rows, cols)
    assert piv_kernels.KERNEL_ROUTE["deform_pairs"] == "cuda"
    stack = torch.as_tensor(_frames(np.random.default_rng(4), 4, 256, 320), device=cuda)
    args = ((256, 320), (16, 16), (8, 8), *win.get_field_shape((256, 320), (16, 16), (8, 8)))
    multipass.piv_multipass(stack, *args, passes=3)
    torch.cuda.synchronize()
    assert piv_kernels.LAUNCHES["deform_pairs"] == before + 1 + 2
    with pytest.raises(ValueError, match="contiguous float32"):
        multipass.deformed_pairs(f.to(torch.float64), ut, vt, rows, cols)


# -- H.264 decode on the card: the YUV conversion kernel (csrc/nv12.cu), the card routes of Video --

H264 = "tests/data/color_322x242.mp4"


@pytest.mark.parametrize(
    "layout,h,w",
    [("offset", 1080, 1920), ("offset", 242, 322), ("offset", 18, 34), ("i420 batch", 1080, 1920),
     ("i420 batch", 2160, 3840)],
)
@pytest.mark.parametrize("gray", [True, False])
def test_yuv420_kernel_bitwise_plain(cuda, layout, h, w, gray):
    """Offset luma views take the kernel's scalar path, ``i420_planes`` of a fresh batch (the main path's
    layout at 1080p and 4K) its 16-byte path; both bit for bit the plain version."""
    from pyorc_tpu_torch.io import nvdec

    g = torch.Generator(device=cuda).manual_seed(h)
    if layout == "i420 batch":
        batch = torch.randint(0, 256, (3, h * w * 3 // 2), dtype=torch.uint8, device=cuda, generator=g)
        y, u, v = nvdec.i420_planes(batch, h, w)
    else:
        y = torch.randint(0, 256, (3, h, w + 6), dtype=torch.uint8, device=cuda, generator=g)[:, :, 2 : w + 2]
        uv = torch.randint(0, 256, (3, h // 2, w), dtype=torch.uint8, device=cuda, generator=g)
        u, v = uv[:, :, 0::2], uv[:, :, 1::2]  # NV12's interleaved chroma: a column stride of 2
        with pytest.raises(ValueError, match="contiguous"):
            nvdec.yuv420_to_frames(y, u, v, gray)  # the wrapper takes rows of unit stride only
        u, v = u.contiguous(), v.contiguous()
    before, paths = piv_kernels.LAUNCHES[nvdec.KERNEL], dict(nvdec.PATHS)
    got = nvdec.yuv420_to_frames(y, u, v, gray)
    assert piv_kernels.LAUNCHES[nvdec.KERNEL] == before + 1 and piv_kernels.KERNEL_ROUTE[nvdec.KERNEL] == "cuda"
    path = "16-byte" if layout == "i420 batch" else "scalar"
    assert nvdec.PATHS == {**paths, path: paths[path] + 1}
    assert torch.equal(got, nvdec.yuv420_to_frames_plain(y, u, v, gray))


def _card_video(path):
    import warnings

    import pyorc_tpu_torch

    pyorc_tpu_torch.set_device("cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return pyorc_tpu_torch.Video(str(path), progress=False)


def test_card_route_frames_equal_cv2(cuda):
    import chip_smoke

    video = _card_video(H264)
    assert video._decode_route == "libav", video._decode_reason
    bgr, _ = chip_smoke._cv2_read(H264)
    got = video._decode_frames(np.arange(len(video.frame_number)), "rgb")
    assert got.device.type == "cuda" and np.array_equal(got.cpu().numpy(), bgr[..., ::-1])


def test_nvdec_plan_names_its_cause(cuda):
    from pyorc_tpu_torch.io import nvdec

    caps, why = nvdec.decoder_caps(cuda)
    plan = nvdec.plan(H264, cuda)
    if why is None:
        assert caps["supported"] and caps["max_width"] >= 3840 and plan == "nvdec", (caps, plan)
        reader = nvdec.NvdecVideoReader(H264, cuda)
        assert reader.read(0, 2, gray=True).shape == (2, 242, 322)
    else:
        assert plan == f"NVDEC unavailable: {why}"


def test_truncated_clip_raises_on_the_card(cuda, tmp_path):
    import chip_smoke

    short = chip_smoke.truncated_copy("tests/data/particles_1080p.mp4", tmp_path / "short.mp4")
    video = _card_video(short)
    assert video._decode_route == "libav", video._decode_reason
    assert video._decode_frames(np.array([0]), "grayscale").device.type == "cuda"
    with pytest.raises((IOError, RuntimeError), match="truncated|short decode|failed"):
        video._decode_frames(np.arange(56, 64), "grayscale")
