"""The port's ensemble PIV against the JAX package on the CPU: the plain
ensemble contract (pyorc_tpu_torch.ops.piv / piv_kernels) against the XLA
scan and the Pallas ensemble kernels B4 and B5 in interpret mode, the
ensemble engine behind ``Frames.get_piv(ensemble_corr=True)``, and the chain
from it to discharge. Inputs are made with numpy from seeds and handed to
both packages."""

import warnings

import numpy as np
import pytest
import torch

import pyorc_tpu
import pyorc_tpu_torch
from pyorc_tpu_torch import _device
from pyorc_tpu.ops import piv as jpiv
from pyorc_tpu.ops import piv_pallas
from pyorc_tpu.ops import windows as jwin
from pyorc_tpu_torch.ops import piv as tpiv
from pyorc_tpu_torch.ops import piv_kernels
from pyorc_tpu_torch.velocimetry import engine

import chip_smoke
from test_piv import make_particle_image, shift_image

H_IMG, W_IMG, N_FRAMES = 480, 640, 10
CAMERA = {"f": 1000.0, "gcp_px": 60, "aoi_px": 100}  # chip_smoke's 4K camera, cut to 480x640
NAMES = ("corr_sum", "count", "cmax", "s2n")


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


def _stack(rng, dims, n_frames, zero_band=False, dark=False):
    """Particle frames shifted (1.5, -0.75) px per frame, scaled to ~[0, 200]."""
    img = make_particle_image(rng, *dims)
    imgs = np.stack([shift_image(img, 1.5 * t, -0.75 * t) for t in range(n_frames)]).astype(np.float32)
    imgs = imgs / imgs.max() * 200.0 + 5.0
    if zero_band:
        imgs[:, dims[0] // 2 :, :] = 0.0  # windows there have zero variance
    if dark:
        imgs[:, : dims[0] // 3, : dims[1] // 3] = 0.0  # below any signal threshold
        imgs[1, dims[0] // 3 :, dims[1] // 3 : 2 * dims[1] // 3] = 0.0  # dark in one frame of two pairs
    return imgs


def _grid(dims, sas, step):
    """(dims, sas, overlap, n_rows, n_cols); ``step`` is an int or a (y, x) pair."""
    sy, sx = (step, step) if isinstance(step, int) else step
    overlap = (sas[0] - sy, sas[1] - sx)
    return dims, sas, overlap, *jwin.get_field_shape(dims, sas, overlap)


def _assert_close(got, want, atol, s2n_atol=None):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        assert (np.isnan(g) == np.isnan(w)).all(), name
        if name == "count":
            np.testing.assert_array_equal(g, w)
        else:
            tol = s2n_atol if name == "s2n" and s2n_atol is not None else atol
            np.testing.assert_allclose(g, w, atol=tol, equal_nan=True, err_msg=name)


@pytest.mark.parametrize(
    "sas,dims,step,n_frames,threshold,zero_band",
    [
        ((16, 16), (72, 160), 8, 4, None, False),
        ((26, 26), (117, 208), 13, 4, None, False),
        ((32, 32), (96, 192), 16, 5, None, True),
        ((64, 64), (160, 224), 32, 4, None, False),
        ((32, 32), (96, 192), 12, 4, None, False),
        ((16, 16), (96, 128), 8, 4, 0.5, False),
        ((64, 128), (192, 448), (32, 64), 4, None, True),
    ],
    ids=["16", "26", "32-zero-even", "64", "32-step12", "16-threshold", "64x128"],
)
def test_plain_ensemble_matches_jax_scan(rng, sas, dims, step, n_frames, threshold, zero_band):
    """The port's scan and the kernel's plain version against the XLA scan:
    corr_sum, cmax and s2n within 2e-3 (tests/test_piv.py:161), counts equal."""
    imgs = _stack(rng, dims, n_frames, zero_band=zero_band, dark=threshold is not None)
    args = _grid(dims, sas, step)
    want = [np.asarray(x) for x in jpiv.piv_ensemble_scan(imgs, *args, 0.2, 3.0, threshold, "fft")]
    count = want[1]
    assert (count > 0).any() and want[2].shape == (n_frames - 1, args[3], args[4])
    if zero_band or threshold is not None:
        assert (count == 0).any()  # the zero-variance or dark windows are never ok
    frames = torch.as_tensor(imgs)
    got = tpiv.piv_ensemble_scan(frames, *args, 0.2, 3.0, threshold)
    _assert_close([x.numpy() for x in got], want, 2e-3)
    got = piv_kernels.piv_ensemble_fused(frames, *args, 0.2, 3.0, threshold)
    assert piv_kernels.KERNEL_ROUTE["piv_ensemble_fused"] == "plain_cpu"
    _assert_close([x.numpy() for x in got], want, 2e-3)


@pytest.mark.parametrize(
    "sas,dims,step,route,tol,s2n_tol",
    [
        ((16, 16), (72, 160), 8, "tileband", 5e-3, 0.15),  # B4, tests/test_piv.py:465
        ((64, 64), (160, 224), 32, "tileband", 2e-3, None),  # B4, tests/test_piv.py:432
        ((32, 32), (96, 192), 8, "sliced", 5e-3, 0.15),  # B5: a step that divides w, not w/2
        ((104, 104), (256, 256), 52, "sliced", 2e-3, None),  # B5 over 64 px: the packed layout's geometry
        ((128, 128), (256, 256), 64, "sliced", 2e-3, None),
    ],
    ids=["B4-16", "B4-64", "B5-32-step8", "B5-104", "B5-128"],
)
def test_plain_ensemble_matches_pallas_interpret(rng, sas, dims, step, route, tol, s2n_tol):
    imgs = _stack(rng, dims, 4)
    args = _grid(dims, sas, step)
    want = [np.asarray(x) for x in piv_pallas.piv_ensemble_fused(imgs, *args, 0.1, 1.5, interpret=True)]
    assert piv_pallas.KERNEL_ROUTE["piv_ensemble_fused"] == route
    got = [x.numpy() for x in piv_kernels.piv_ensemble_fused(torch.as_tensor(imgs), *args, 0.1, 1.5)]
    assert (want[1] > 0).any()
    _assert_close(got, want, tol, s2n_tol)


def test_kernel_wrapper_rejects_unsupported_geometry():
    """Windows the ensemble kernel does not take (a side under 8 or over 128 px) raise before any CUDA call."""
    frames = torch.zeros((3, 256, 256))
    for sas in ((6, 6), (130, 130), (136, 64)):
        with pytest.raises(ValueError, match="sides of 8-128 px.*ROADMAP.md, queue B"):
            piv_kernels._launch_ensemble(frames, sas, (sas[0] // 2, sas[1] // 2), 3, 3, 0.2, 3.0, None)
    with pytest.raises(ValueError, match="at least 2"):
        piv_kernels._launch_ensemble(frames[:1], (16, 16), (8, 8), 31, 31, 0.2, 3.0, None)
    with pytest.raises(ValueError, match="does not match"):
        piv_kernels.piv_ensemble_fused(frames, (256, 256), (16, 16), (8, 8), 30, 31)


@pytest.fixture(scope="module")
def projected():
    """(port cc, JAX cc, port projected frames, JAX projected frames) at 30 fps."""
    pyorc_tpu_torch.set_device("cpu")
    cc_t = chip_smoke.nadir_camera_config(H_IMG, W_IMG, window_size=64, **CAMERA)
    cc_j = pyorc_tpu.get_camera_config(cc_t.to_json())
    stack = chip_smoke.advected_stack(H_IMG, W_IMG, N_FRAMES, "cpu")
    fps = chip_smoke.ENS_FPS
    proj_t = chip_smoke.frames_dataarray(stack, cc_t, fps=fps).frames.normalize(samples=15).frames.project()
    proj_j = (
        chip_smoke.frames_dataarray(stack, cc_j, pyorc_tpu, fps=fps).frames.normalize(samples=15).frames.project()
    )
    return cc_t, cc_j, proj_t, proj_j


@pytest.mark.parametrize("engine", ["xla", "fused-interpret"])
def test_ensemble_chain_matches_jax(projected, monkeypatch, engine):
    """get_piv(ensemble_corr=True) -> spatial masks -> transect -> Q in both
    packages (JAX through its XLA scan, then through the Pallas kernel in
    interpret mode): one time step, v_x / v_y within 2e-3 m/s, corr / s2n
    within 2e-3, NaN masks equal, Q within 1 %."""
    monkeypatch.setenv("PYORC_TPU_ENGINE", engine)
    monkeypatch.setenv("PYORC_TPU_SHARD", "0")  # conftest forces 8 CPU devices
    cc_t, cc_j, proj_t, proj_j = projected
    aoi = CAMERA["aoi_px"]
    piv_t, q_t = chip_smoke.run_chain(proj_t, 64, cc_t, {}, aoi_px=aoi, ensemble=True)
    assert piv_kernels.KERNEL_ROUTE["piv_ensemble_fused"] == "plain_cpu"
    piv_j, q_j = chip_smoke.run_chain(proj_j, 64, cc_j, {}, aoi_px=aoi, ensemble=True)
    if engine == "fused-interpret":
        assert piv_pallas.KERNEL_ROUTE["piv_ensemble_fused"] == "tileband"
    for name, tol in (("v_x", 2e-3), ("v_y", 2e-3), ("corr", 2e-3), ("s2n", 2e-3)):
        got, want = piv_t[name].values, np.asarray(piv_j[name].values)
        assert got.shape == want.shape == (1,) + got.shape[1:]
        assert (np.isnan(got) == np.isnan(want)).all(), name
        np.testing.assert_allclose(got, want, atol=tol, equal_nan=True, err_msg=name)
    np.testing.assert_array_equal(piv_t["time"].values, np.asarray(piv_j["time"].values))
    kw = dict(rel_tol=chip_smoke.ENS_VEL_RTOL, fps=chip_smoke.ENS_FPS)
    res_t = chip_smoke.check_chain(piv_t, q_t, cc_t, 64, **kw)
    res_j = chip_smoke.check_chain(piv_j, q_j, cc_j, 64, **kw)
    assert abs(res_t["Q"] - res_j["Q"]) < 0.01 * abs(res_j["Q"])
    assert res_t["Q"] > 0


def _with_dark_band(proj, n_dark):
    """The projected frames with a top band dark (zero variance) in the first ``n_dark`` frames."""
    data = np.array(proj.values)
    data[:n_dark, :96, :] = 0
    return proj.frames._with_data(data)


def test_ensemble_count_min_matches_jax(projected, monkeypatch):
    """A band without texture in 6 of 10 frames leaves its windows 3 of 9 ok
    pairs: count_min 0.2 keeps them, 0.5 takes out the same cells in both
    packages (NaN v_x, v_y and corr)."""
    monkeypatch.setenv("PYORC_TPU_SHARD", "0")
    _, _, proj_t, proj_j = projected
    dark_t, dark_j = _with_dark_band(proj_t, 6), _with_dark_band(proj_j, 6)
    kw = dict(window_size=64, overlap=(32, 32), ensemble_corr=True)
    for count_min in (0.2, 0.5):
        got = dark_t.frames.get_piv(count_min=count_min, **kw)
        want = dark_j.frames.get_piv(count_min=count_min, **kw)
        for name in ("v_x", "v_y", "corr"):
            g, w = got[name].values, np.asarray(want[name].values)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        low = np.isnan(got["v_x"].values[0])
        if count_min == 0.2:
            assert not low.any()
        else:
            assert low[:2].all() and not low[3:].any()


def test_ensemble_chunked_equals_one_chunk(projected):
    """5-frame chunks (one-frame overlap) give the one-chunk result: per-pair
    stats join unchanged, so corr and s2n are equal; corr_sum adds chunk
    sums, which changes only float rounding in the mean plane."""
    _, _, proj_t, _ = projected
    kw = dict(window_size=64, overlap=(32, 32), ensemble_corr=True)
    whole = proj_t.frames.get_piv(**kw)
    chunked = proj_t.frames.get_piv(chunksize=5, **kw)
    for name in ("corr", "s2n"):
        np.testing.assert_array_equal(chunked[name].values, whole[name].values)
    for name in ("v_x", "v_y"):
        np.testing.assert_allclose(chunked[name].values, whole[name].values, rtol=1e-5, atol=1e-6)


def _numpy_finish(corr_sum, corr_count, cmax_all, s2n_all, count_min, n_pairs_total, n_rows, n_cols):
    """The engine's ensemble finish as it ran on the host before it moved to the device (the JAX package's):
    (u, v, corr, s2n), u and v in px, each [n_rows, n_cols]."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        low_count = corr_count < count_min * n_pairs_total
        corr_sum[low_count] = np.nan
        flat_low = low_count.reshape(n_rows, n_cols)
        cmax_all = np.where(flat_low[None], np.nan, cmax_all)
        corr_mean = corr_sum / np.maximum(corr_count, 1)[..., None, None]
        corr_mean[corr_count == 0] = np.nan
        cmax_masked = np.where(cmax_all == 0.0, np.nan, cmax_all)
        s2n_masked = np.where(s2n_all == 0.0, np.nan, s2n_all)
        cmax_mean = np.nanmean(cmax_masked, axis=0).reshape(n_rows, n_cols)
        s2n_mean = np.nanmean(s2n_masked, axis=0).reshape(n_rows, n_cols)
    u, v = tpiv.u_v_displacement(torch.as_tensor(corr_mean)[None], n_rows, n_cols)
    u, v = u.numpy()[0], v.numpy()[0]
    u[flat_low] = np.nan
    v[flat_low] = np.nan
    return u, v, cmax_mean, s2n_mean


@pytest.mark.parametrize("n_dark, count_min", [(6, 0.2), (6, 0.5), (10, 0.0)])
def test_ensemble_finish_matches_the_numpy_finish(projected, n_dark, count_min):
    """The finish on the device that holds the chunks' results against the numpy finish it replaced, on the
    dark-band stack: NaN masks equal, corr and s2n within 1e-6 relative, u and v within 1e-5 px. A band dark in
    every frame leaves its cells no ok pair, so that count_min 0 still takes them out."""
    _, _, proj_t, _ = projected
    data = torch.as_tensor(np.asarray(_with_dark_band(proj_t, n_dark).values))
    args = _grid(tuple(data.shape[1:]), (64, 64), 32)
    n_rows, n_cols = args[3:]
    out = piv_kernels.piv_ensemble_routed(data, *args)
    n_pairs = data.shape[0] - 1
    got = engine._ensemble_finish(*out, count_min, n_pairs, n_rows, n_cols).numpy()
    want = _numpy_finish(*(t.numpy().copy() for t in out), count_min, n_pairs, n_rows, n_cols)
    count = out[1].numpy().reshape(n_rows, n_cols)
    low, none = count < count_min * n_pairs, count == 0
    assert low.any() == (count_min == 0.5) and none.any() == (n_dark == 10)
    # a cell no pair counts has no corr or s2n mean; its NaN mean plane still gives a clamped peak (as in JAX)
    nan_cells = {"u": low, "v": low, "corr": low | none, "s2n": none}
    for name, g, w in zip(("u", "v", "corr", "s2n"), got, want):
        assert g.shape == w.shape == (n_rows, n_cols)
        np.testing.assert_array_equal(np.isnan(w), nan_cells[name], err_msg=name)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        if name in ("u", "v"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, equal_nan=True, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, equal_nan=True, err_msg=name)


@pytest.mark.parametrize("chunksize", [None, 5])
def test_ensemble_brings_down_only_the_fields(projected, chunksize):
    """Over an ensemble get_piv only the four fields come down: no per-pair statistic and no plane, whatever
    the chunk plan (the CPU device counts its copies too)."""
    _, _, proj_t, _ = projected
    before = _device.COPY_BYTES["d2h"]
    piv = proj_t.frames.get_piv(window_size=64, overlap=(32, 32), ensemble_corr=True, chunksize=chunksize)
    n_rows, n_cols = piv["v_x"].shape[1:]
    assert _device.COPY_BYTES["d2h"] - before == 4 * n_rows * n_cols * 4


def test_ensemble_with_passes_raises(projected):
    """Ensemble PIV with passes > 1 raises; per-pair multipass (128 -> 64 px) runs."""
    _, _, proj_t, _ = projected
    with pytest.raises(ValueError, match="passes"):
        proj_t.frames.get_piv(window_size=64, overlap=(32, 32), ensemble_corr=True, passes=2)
    piv = proj_t.frames.get_piv(window_size=64, overlap=(32, 32), passes=2)
    assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "plain_cpu"
    v_x = piv["v_x"].values
    assert v_x.shape[0] == N_FRAMES - 1 and np.isfinite(v_x).mean() > 0.9


def test_ensemble_main_path_check_on_cpu(monkeypatch):
    """chip_smoke's ensemble slice and main-path check, rehearsed on the CPU:
    the plain version stands in for the kernel on both sides of the check."""
    res, times, proj, piv = chip_smoke.ensemble_slice_phase(H_IMG, W_IMG, 8, "cpu", camera=CAMERA)
    assert set(times) == {f"{s}[ens]" for s in ("normalize", "project", "get_piv", "mask", "transect_q_flow")}
    assert abs(res["v_x"] - res["v_x_true"]) < chip_smoke.ENS_VEL_RTOL * abs(res["v_x_true"])
    plain = piv_kernels.piv_ensemble_fused

    def as_if_cuda(*args, **kwargs):
        out = plain(*args, **kwargs)
        piv_kernels.KERNEL_ROUTE["piv_ensemble_fused"] = "cuda"
        return out

    monkeypatch.setattr(piv_kernels, "piv_ensemble_fused", as_if_cuda)
    out = chip_smoke.ensemble_main_path_check(proj, piv, "cpu")
    assert out["gate_flips"] == 0 and out["max_abs_duv_px"] == 0.0
    assert out["bound_by"] == "operations" and out["bound_ms"] > 0


@pytest.mark.parametrize("ensemble", [False, True], ids=["pairs", "ensemble"])
def test_oom_halving_matches_one_chunk(projected, monkeypatch, ensemble):
    """A device out-of-memory error on a chunk of over 3 pairs retries it as
    two halves, each with its halo of frames, down to chunks that fit;
    per-pair outputs join bit for bit and ensemble sums add (float rounding
    only)."""
    _, _, proj_t, _ = projected
    kw = dict(window_size=64, overlap=(32, 32), ensemble_corr=ensemble)
    whole = proj_t.frames.get_piv(**kw)
    name = "piv_ensemble_fused" if ensemble else "piv_pairs_fused"
    kernel = getattr(piv_kernels, name)
    ran = []

    def small_chunks_only(frames, *args, **kwargs):
        n_pairs = frames.shape[0] - 1 - sum(kwargs.get("halo", (0, 0)))
        if n_pairs > 3:
            raise torch.cuda.OutOfMemoryError("chunk too large")
        ran.append(n_pairs)
        return kernel(frames, *args, **kwargs)

    monkeypatch.setattr(piv_kernels, name, small_chunks_only)
    with pytest.warns(UserWarning, match="two halves"):
        split = proj_t.frames.get_piv(**kw)
    assert sum(ran) == N_FRAMES - 1 and len(ran) > 2
    for var in ("corr", "s2n"):
        np.testing.assert_array_equal(split[var].values, whole[var].values)
    for var in ("v_x", "v_y"):
        if ensemble:
            np.testing.assert_allclose(split[var].values, whole[var].values, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(split[var].values, whole[var].values)


def test_jax_pallas_ensemble_non_square_fault():
    """Pins the JAX package's non-square fault on its ensemble route: B5
    builds the same ``_packed_mats`` as B2 and raises (ROADMAP C); the port's
    non-square ensemble is held against ``piv_ensemble_scan`` instead (the
    64x128 case above). When JAX is fixed, this test fails and says so."""
    imgs = _stack(np.random.default_rng(3), (128, 256), 3)
    args = _grid((128, 256), (64, 128), (32, 64))
    with pytest.raises(ValueError, match="same shape") as err:
        piv_pallas.piv_ensemble_fused(imgs, *args, interpret=True)
    assert "_packed_mats" in {entry.name for entry in err.traceback}


def test_ensemble_routes_wide_windows_to_torch_ops(projected):
    """Windows over 128 px go by plan to the plain scan (route "torch_ops"), as
    the JAX package sends them to its XLA scan; the engine's result is the
    scan's."""
    _, _, proj_t, _ = projected
    data = torch.as_tensor(np.asarray(proj_t.values))
    dims = tuple(data.shape[1:])
    args = _grid(dims, (136, 136), 68)
    out = piv_kernels.piv_ensemble_routed(data, *args)
    assert piv_kernels.KERNEL_ROUTE["piv_ensemble_fused"] == "torch_ops"
    want = tpiv.piv_ensemble_scan(data, *args)
    for g, w in zip(out, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    piv = proj_t.frames.get_piv(window_size=136, overlap=(68, 68), ensemble_corr=True)
    assert piv_kernels.KERNEL_ROUTE["piv_ensemble_fused"] == "torch_ops"
    assert piv["v_x"].values.shape == (1, args[3], args[4])


@pytest.fixture(scope="module")
def projected_wide():
    """(port cc, JAX cc, port projected frames, JAX projected frames) at 600x800,
    where 128 px windows leave a few rows of them along the transect."""
    pyorc_tpu_torch.set_device("cpu")
    cc_t = chip_smoke.nadir_camera_config(600, 800, window_size=64, **CAMERA)
    cc_j = pyorc_tpu.get_camera_config(cc_t.to_json())
    stack = chip_smoke.advected_stack(600, 800, 8, "cpu")
    fps = chip_smoke.ENS_FPS
    proj_t = chip_smoke.frames_dataarray(stack, cc_t, fps=fps).frames.normalize(samples=15).frames.project()
    proj_j = (
        chip_smoke.frames_dataarray(stack, cc_j, pyorc_tpu, fps=fps).frames.normalize(samples=15).frames.project()
    )
    return cc_t, cc_j, proj_t, proj_j


def test_wide_ensemble_chain_matches_jax(projected_wide, monkeypatch):
    """chip_smoke's wide ensemble path (get_piv at 128 px with
    ensemble_corr=True -> spatial masks -> transect -> Q) in both packages,
    JAX through B5 in interpret mode (route "sliced"): v_x / v_y within
    2e-3 m/s, corr / s2n within 2e-3, NaN masks equal, Q within 1 %, both
    within the smoke run's bounds of the truth."""
    monkeypatch.setenv("PYORC_TPU_ENGINE", "fused-interpret")
    monkeypatch.setenv("PYORC_TPU_SHARD", "0")
    cc_t, cc_j, proj_t, proj_j = projected_wide
    res_t, _, piv_t = chip_smoke.wide_ensemble_phase(proj_t, 600, 800, camera=CAMERA)
    assert piv_kernels.KERNEL_ROUTE["piv_ensemble_fused"] == "plain_cpu"
    res_j, _, piv_j = chip_smoke.wide_ensemble_phase(proj_j, 600, 800, camera=CAMERA)
    assert piv_pallas.KERNEL_ROUTE["piv_ensemble_fused"] == "sliced"
    for name in ("v_x", "v_y", "corr", "s2n"):
        got, want = piv_t[name].values, np.asarray(piv_j[name].values)
        assert got.shape == want.shape == (1,) + got.shape[1:]
        assert (np.isnan(got) == np.isnan(want)).all(), name
        np.testing.assert_allclose(got, want, atol=2e-3, equal_nan=True, err_msg=name)
    for name in ("v_x", "v_y"):
        assert abs(res_t[name] - res_j[name]) < 2e-3
    assert abs(res_t["Q"] - res_j["Q"]) < 0.01 * abs(res_j["Q"])
