"""The port's multipass PIV against the JAX package on the CPU.

Module parity (window schedule, the normalized median test, the bilinear
resampling and the symmetric deformation), ``piv_multipass`` against the JAX
package's XLA cascade and its kernel route (the Pallas kernels in interpret
mode, B2 at 128 px), the engine behind ``Frames.get_piv(passes=N)`` and the
chain from it to discharge, and ``chip_smoke.py``'s multipass phases
rehearsed on the CPU. Inputs are made with numpy from seeds and handed to
both packages. Tolerances:

- modules: the median test within 1e-6 px, the resampling and deformation
  within 1e-5 (the same float32 operations in both packages);
- ``piv_multipass``: u, v within 1e-3 px on windows whose last-pass top-2
  peak gap exceeds 5e-3 (``chip_smoke.hold_pairs``' criterion), cmax within
  1e-4; against the interpret route also JAX's own bound (90 % of |d| under
  0.05 px, tests/test_piv.py:556-558);
- the chain: v_x / v_y within 2e-3 m/s, Q within 1 %.
"""

import numpy as np
import pytest
import torch

import pyorc_tpu
import pyorc_tpu_torch
from pyorc_tpu.ops import multipass as jmp
from pyorc_tpu.ops import piv_pallas
from pyorc_tpu.ops import windows as jwin
from pyorc_tpu_torch.ops import multipass as tmp
from pyorc_tpu_torch.ops import piv as tpiv
from pyorc_tpu_torch.ops import piv_kernels

import chip_smoke
from test_piv import make_particle_image, shift_image

H_IMG, W_IMG, N_FRAMES = 480, 640, 12  # the stack of tests/test_torch_slice.py


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


@pytest.mark.parametrize(
    "window_size,passes",
    [((16, 16), 3), ((25, 25), 3), ((26, 26), 3), ((32, 32), 3), ((64, 64), 2), ((32, 32), 1)],
)
def test_window_schedule_matches_jax(window_size, passes):
    got = tmp.multipass_window_sizes(window_size, passes)
    assert got == jmp.multipass_window_sizes(window_size, passes)
    assert got[-1] == tuple(w + w % 2 for w in window_size)


def test_nanmedian_averages_the_two_middle_values():
    """jnp.nanmedian of an even count is the mean of the two middle values;
    torch.nanmedian gives the lower one, which the port must not use."""
    x = torch.tensor([[5.0, 1.0, float("nan"), 8.0, 3.0, 2.0, 7.0, 6.0, 4.0]])
    assert float(torch.nanmedian(x)) == 4.0
    assert float(tmp._nanmedian(x, -1)) == 4.5
    assert torch.isnan(tmp._nanmedian(torch.full((2, 8), float("nan")), -1)).all()


def _fields(case):
    rng = np.random.default_rng({"outliers": 1, "nan-blocks": 2, "smooth-even": 3}[case])
    u = rng.normal(2.0, 0.1, (3, 9, 11)).astype(np.float32)
    v = rng.normal(-1.0, 0.1, (3, 9, 11)).astype(np.float32)
    if case == "outliers":
        u[0, 3, 4], u[1, 0, 0], v[2, 8, 10], v[0, 5, 5] = 25.0, -9.0, 12.0, -30.0
        u[1, 6, 2] = v[2, 1, 7] = np.nan
    elif case == "nan-blocks":
        u[0, 2:7, 3:8] = np.nan  # the centre cells' neighbourhoods are all NaN
        v[1, :4, :4] = np.nan  # a corner: edge padding repeats the NaNs
        u[2, 4, :] = np.nan
        v[2, 4, 5] = 40.0
    else:
        # every neighbourhood holds 8 values; a quantised field has ties and even counts of equals
        u = np.round(u * 20) / 20
        v[:, ::2, ::3] = np.nan  # leaves 5-7 finite neighbours, even and odd counts
    return u, v


@pytest.mark.parametrize("case", ["outliers", "nan-blocks", "smooth-even"])
def test_median_validate_matches_jax(case):
    u, v = _fields(case)
    want = [np.asarray(x) for x in jmp._median_validate(u, v)]
    got = [x.numpy() for x in tmp._median_validate(torch.as_tensor(u), torch.as_tensor(v))]
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and np.isfinite(w).all()
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    if case == "outliers":
        assert abs(got[0][0, 3, 4] - 2.0) < 0.5 and abs(got[1][0, 5, 5] + 1.0) < 0.5
    if case == "nan-blocks":
        assert got[0][0, 4, 5] == 0.0  # all-NaN neighbourhood: NaN median, then nan_to_num


def test_grid_resampling_and_deformation_match_jax():
    """Window-grid field -> pixel grid and -> a finer window grid, and the
    symmetric deformation with displacements that sample outside the frame."""
    rng = np.random.default_rng(5)
    h, w = 96, 130
    cols_c, rows_c = jwin.get_rect_coordinates((h, w), (32, 32), (32, 32), (16, 16))
    cols_f, rows_f = jwin.get_rect_coordinates((h, w), (16, 16), (16, 16), (8, 8))
    field = rng.normal(0.0, 6.0, (2, len(rows_c), len(cols_c))).astype(np.float32)
    want = np.asarray(jmp._grid_to_dense(field, rows_c, cols_c, h, w))
    got = tmp._grid_to_dense(torch.as_tensor(field), rows_c, cols_c, h, w).numpy()
    assert got.shape == (2, h, w)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    want = np.asarray(jmp._grid_to_grid(field, rows_c, cols_c, rows_f, cols_f))
    got = tmp._grid_to_grid(torch.as_tensor(field), rows_c, cols_c, rows_f, cols_f).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    img_a = rng.uniform(0, 255, (h, w)).astype(np.float32)
    img_b = rng.uniform(0, 255, (h, w)).astype(np.float32)
    dr = np.asarray(jmp._grid_to_dense(field[0], rows_c, cols_c, h, w)) * 4  # up to ~70 px: off the frame
    dc = np.asarray(jmp._grid_to_dense(field[1], rows_c, cols_c, h, w)) * 4
    assert np.abs(dr).max() > 40 and np.abs(dc).max() > 40
    want = [np.asarray(x) for x in jmp._deform_pair(img_a, img_b, dr, dc)]
    got = [x.numpy() for x in tmp._deform_pair(*(torch.as_tensor(x) for x in (img_a, img_b, dr, dc)))]
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g, wt, atol=1e-5 * 255, rtol=0)


def _shift_frames(rng):
    img = make_particle_image(rng, 256, 320)
    return np.stack([img, shift_image(img, 2.3, -1.7), shift_image(img, 4.1, -3.0)]).astype(np.float32)


def _shear_frames(rng):
    from scipy.ndimage import map_coordinates

    img = make_particle_image(rng, 256, 320)
    yy, xx = np.mgrid[0:256, 0:320].astype(float)
    frames = [img] + [map_coordinates(img, [yy, xx - a * yy], order=3, mode="nearest") for a in (0.02, 0.035)]
    return np.stack(frames).astype(np.float32)


def _record_last_pass(monkeypatch):
    """Wrap the port's kernel entry point to keep its last call (the last pass's pairs and grid)."""
    calls = []
    kernel = piv_kernels.piv_pairs_fused

    def recording(pairs, *args, **kwargs):
        calls.append((pairs, args, kwargs))
        return kernel(pairs, *args, **kwargs)

    monkeypatch.setattr(piv_kernels, "piv_pairs_fused", recording)
    return calls


def _hold_to_jax(got, want, calls, tol=1e-3):
    """u, v within ``tol`` px where the port's last-pass top-2 gap exceeds 5e-3;
    cmax within 1e-4 and s2n within 1e-3 relative where JAX's is finite."""
    pairs, args, kwargs = calls[-1]
    assert kwargs == {"pair_stride": 2}
    gap = tpiv.top2_gap(pairs, *args[:3], 2).reshape(got[0].shape).numpy()
    u, v, cmax, s2n = (x.numpy() for x in got)
    ju, jv, jcmax, js2n = (np.asarray(x) for x in want)
    assert u.shape == ju.shape
    confident = (gap > 5e-3) & np.isfinite(u) & np.isfinite(ju)
    assert confident.sum() > 0.9 * np.isfinite(u).sum()
    assert np.abs(u - ju)[confident].max() <= tol and np.abs(v - jv)[confident].max() <= tol
    finite = np.isfinite(jcmax)
    assert np.abs(cmax - jcmax)[finite].max() <= 1e-4
    ok = finite & np.isfinite(js2n)
    assert (np.abs(s2n - js2n) / np.abs(js2n).clip(1e-6))[ok].max() <= 1e-3


@pytest.mark.parametrize("passes", [2, 3])
@pytest.mark.parametrize("motion", ["shift", "shear"])
def test_multipass_matches_jax_cascade(rng, monkeypatch, passes, motion):
    """The port (plain kernel version on the CPU) against JAX's XLA cascade,
    32 px at 16 px overlap on 256x320 frames: the first pass of passes=3 is 128 px."""
    frames = (_shift_frames if motion == "shift" else _shear_frames)(rng)
    dims, ws, ov = (256, 320), (32, 32), (16, 16)
    nr, nc = jwin.get_field_shape(dims, ws, ov)
    want = jmp.piv_multipass(frames, dims, ws, ov, nr, nc, passes=passes, engine="xla")
    calls = _record_last_pass(monkeypatch)
    got = tmp.piv_multipass(torch.as_tensor(frames), dims, ws, ov, nr, nc, passes=passes)
    assert [c[1][1] for c in calls] == tmp.multipass_window_sizes(ws, passes)
    assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "plain_cpu"
    for a, b in zip(got, want):
        assert (np.isnan(a.numpy()) == np.isnan(np.asarray(b))).all()
    _hold_to_jax(got, want, calls)
    if motion == "shift":
        u = got[0].numpy()[:, 2:-2, 2:-2]
        assert abs(np.median(u[0]) - 2.3) < 0.05 and abs(np.median(u[1]) - 1.8) < 0.05


def test_multipass_matches_jax_kernel_route_at_128px(rng, monkeypatch):
    """JAX's kernel route (``engine="fused-interpret"``): the 128 and 64 px
    passes run Pallas B2 in interpret mode, the 32 px pass B3."""
    frames = _shift_frames(rng)
    dims, ws, ov = (256, 320), (32, 32), (16, 16)
    nr, nc = jwin.get_field_shape(dims, ws, ov)
    routes = []
    pallas = piv_pallas.piv_pairs_fused

    def recording(imgs, dim_size, sas, *args, **kwargs):
        out = pallas(imgs, dim_size, sas, *args, **kwargs)
        routes.append((sas[0], piv_pallas.KERNEL_ROUTE["piv_pairs_fused"]))
        return out

    monkeypatch.setattr(piv_pallas, "piv_pairs_fused", recording)
    want = jmp.piv_multipass(frames, dims, ws, ov, nr, nc, passes=3, engine="fused-interpret")
    assert [r[0] for r in routes] == [128, 64, 32] and "xla" not in {r[1] for r in routes}
    calls = _record_last_pass(monkeypatch)
    got = tmp.piv_multipass(torch.as_tensor(frames), dims, ws, ov, nr, nc, passes=3)
    d = np.abs(got[0].numpy() - np.asarray(want[0]))
    assert np.quantile(d[np.isfinite(d)], 0.9) < 0.05
    _hold_to_jax(got, want, calls)


def test_multipass_signal_threshold_against_cascade(rng, monkeypatch):
    """With signal_threshold JAX always runs its cascade. Windows above the
    threshold agree; below it the cascade reports NaN cmax / s2n and the
    placeholder u / v of an all-NaN plane, the port NaN in all four."""
    frames = _shift_frames(rng) * 1000.0
    frames[:, :96, :128] = 0.0  # dark in every frame
    frames[1, 120:200, 150:260] = 0.0  # dark in the middle frame only
    dims, ws, ov = (256, 320), (32, 32), (16, 16)
    nr, nc = jwin.get_field_shape(dims, ws, ov)
    want = [np.asarray(x) for x in jmp.piv_multipass(frames, dims, ws, ov, nr, nc, passes=3, signal_threshold=0.5)]
    calls = _record_last_pass(monkeypatch)
    got = tmp.piv_multipass(torch.as_tensor(frames), dims, ws, ov, nr, nc, passes=3, signal_threshold=0.5)
    low = np.isnan(want[2])
    assert low.sum() > 20 and (~low).sum() > 100
    assert np.isnan(want[3][low]).all() and np.isfinite(want[0][low]).all()  # the cascade's placeholder
    for x in got:
        assert np.isnan(x.numpy()[low]).all() and np.isfinite(x.numpy()[~low]).all()
    _hold_to_jax(got, want, calls)


@pytest.fixture(scope="module")
def projected():
    """(port cc, JAX cc, port projected frames, JAX projected frames): chip_smoke's slice at 480x640."""
    pyorc_tpu_torch.set_device("cpu")
    cc_t = chip_smoke.nadir_camera_config(H_IMG, W_IMG)
    cc_j = pyorc_tpu.get_camera_config(cc_t.to_json())
    stack = chip_smoke.advected_stack(H_IMG, W_IMG, N_FRAMES, "cpu")
    proj_t = chip_smoke.frames_dataarray(stack, cc_t).frames.normalize(samples=15).frames.project()
    proj_j = chip_smoke.frames_dataarray(stack, cc_j, pyorc_tpu).frames.normalize(samples=15).frames.project()
    return cc_t, cc_j, proj_t, proj_j


def test_get_piv_multipass_chain_matches_jax(projected, monkeypatch):
    """get_piv(window_size=32, overlap=16, passes=2) -> mask -> transect -> Q
    in both packages on the same projected stack (JAX's XLA cascade)."""
    monkeypatch.setenv("PYORC_TPU_SHARD", "0")  # conftest forces 8 CPU devices
    cc_t, cc_j, proj_t, proj_j = projected
    piv_t, q_t = chip_smoke.run_chain(proj_t, 32, cc_t, {}, passes=2)
    assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "plain_cpu"
    piv_j, q_j = chip_smoke.run_chain(proj_j, 32, cc_j, {}, passes=2)
    for name in ("v_x", "v_y", "corr", "s2n"):
        got, want = piv_t[name].values, np.asarray(piv_j[name].values)
        assert got.shape == want.shape == (N_FRAMES - 1,) + got.shape[1:]
        assert (np.isnan(got) == np.isnan(want)).all(), name
        tol = 2e-3 if name.startswith("v_") else 1e-3
        np.testing.assert_allclose(got, want, atol=tol, rtol=0 if name != "s2n" else 1e-3, equal_nan=True, err_msg=name)
    res_t = chip_smoke.check_chain(piv_t, q_t, cc_t, 32, abs_tol=chip_smoke.VEL_TOL[26])
    res_j = chip_smoke.check_chain(piv_j, q_j, cc_j, 32, abs_tol=chip_smoke.VEL_TOL[26])
    for name in ("v_x", "v_y"):
        assert abs(res_t[name] - res_j[name]) < 2e-3
    assert abs(res_t["Q"] - res_j["Q"]) < 0.01 * abs(res_j["Q"])
    assert res_t["Q"] > 0


def test_get_piv_multipass_256px_pass_matches_jax(projected, monkeypatch):
    """get_piv(window_size=64, passes=3): passes of 256, 128 and 64 px. The
    256 px pass is over the kernels' 128 px, so it goes by plan to the plain
    tensor ops (route "torch_ops"), as JAX's kernel route sends it to its XLA
    pipeline; the others take the kernel's plain version. Held to JAX's
    cascade on the same projected stack within the chain test's tolerances."""
    monkeypatch.setenv("PYORC_TPU_SHARD", "0")
    _, _, proj_t, proj_j = projected
    routes = []
    routed = piv_kernels.piv_pairs_routed

    def recording(pairs, dim_size, sas, *args, **kwargs):
        out = routed(pairs, dim_size, sas, *args, **kwargs)
        routes.append((tuple(sas), piv_kernels.KERNEL_ROUTE["piv_pairs_fused"]))
        return out

    monkeypatch.setattr(piv_kernels, "piv_pairs_routed", recording)
    kw = dict(window_size=64, overlap=(32, 32), passes=3)
    piv_t = proj_t.frames.get_piv(**kw)
    assert routes == [((256, 256), "torch_ops"), ((128, 128), "plain_cpu"), ((64, 64), "plain_cpu")]
    piv_j = proj_j.frames.get_piv(**kw)
    for name in ("v_x", "v_y", "corr", "s2n"):
        got, want = piv_t[name].values, np.asarray(piv_j[name].values)
        assert got.shape == want.shape == (N_FRAMES - 1,) + got.shape[1:]
        assert (np.isnan(got) == np.isnan(want)).all(), name
        tol = 2e-3 if name.startswith("v_") else 1e-3
        np.testing.assert_allclose(got, want, atol=tol, rtol=0 if name != "s2n" else 1e-3, equal_nan=True, err_msg=name)
    assert np.isfinite(piv_t["v_x"].values).mean() > 0.9


def test_get_piv_multipass_chunked_equals_whole(projected):
    """5-frame chunks (one-frame overlap) give the one-chunk result exactly:
    every pass is per pair."""
    _, _, proj_t, _ = projected
    kw = dict(window_size=25, overlap=(13, 13), passes=3)
    whole = proj_t.frames.get_piv(**kw)
    chunked = proj_t.frames.get_piv(chunksize=5, **kw)
    assert whole["v_x"].values.shape[0] == N_FRAMES - 1
    for name in ("v_x", "v_y", "corr", "s2n"):
        np.testing.assert_array_equal(chunked[name].values, whole[name].values)


def test_multipass_phases_on_cpu(projected, monkeypatch):
    """chip_smoke's multipass slice and main-path check, rehearsed on the CPU:
    the plain version stands in for the kernel on both sides of the check."""
    _, _, proj_t, _ = projected
    results, times, pivs = chip_smoke.multipass_phase(proj_t, H_IMG, W_IMG)
    assert set(results) == {32, 26} and set(times) == {
        f"{s}[{w}px x3]" for w in (32, 26) for s in ("get_piv", "mask", "transect_q_flow")
    }
    for res in results.values():
        assert res["launches"] == 0 and res["passes"] == 3  # the plain version counts no launch
        for name in ("v_x", "v_y"):
            assert abs(res[name] - res[name + "_true"]) < chip_smoke.VEL_TOL[26]
    plain = piv_kernels.piv_pairs_fused

    def as_if_cuda(*args, **kwargs):
        out = plain(*args, **kwargs)
        piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] = "cuda"
        return out

    monkeypatch.setattr(piv_kernels, "piv_pairs_fused", as_if_cuda)
    out = chip_smoke.multipass_main_path_check(proj_t, pivs[32], "cpu")
    assert out["max_abs_duv_px"] == 0.0 and [p["window"] for p in out["passes"]] == [128, 64, 32]
    assert all(p["bound_by"] == "operations" and p["bound_ms"] > 0 for p in out["passes"])
