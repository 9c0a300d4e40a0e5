"""The port's main path against the JAX package on the CPU: a 480x640,
12-frame in-memory stack advected by a known sub-pixel shift goes through
normalize -> project -> get_piv -> mask -> get_transect -> get_q ->
get_river_flow in both packages (JAX with the Pallas kernels in interpret
mode), and the results are held against each other and the analytic truth.
The stack, the camera and the chain are those of ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import pyorc_tpu
import pyorc_tpu_torch
from pyorc_tpu.ops import piv_pallas
from pyorc_tpu_torch.ops import piv_kernels

import chip_smoke

H_IMG, W_IMG, N_FRAMES = 480, 640, 12


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def projected():
    """(port cc, JAX cc, port projected frames, JAX projected frames)."""
    pyorc_tpu_torch.set_device("cpu")
    cc_t = chip_smoke.nadir_camera_config(H_IMG, W_IMG)
    cc_j = pyorc_tpu.get_camera_config(cc_t.to_json())
    stack = chip_smoke.advected_stack(H_IMG, W_IMG, N_FRAMES, "cpu")
    proj_t = chip_smoke.frames_dataarray(stack, cc_t).frames.normalize(samples=15).frames.project()
    proj_j = chip_smoke.frames_dataarray(stack, cc_j, pyorc_tpu).frames.normalize(samples=15).frames.project()
    return cc_t, cc_j, proj_t, proj_j


def test_normalize_project_identical(projected):
    _, _, proj_t, proj_j = projected
    np.testing.assert_array_equal(proj_t.values, np.asarray(proj_j.values))
    for name in ("x", "y", "xs", "ys"):
        np.testing.assert_array_equal(proj_t[name].values, proj_j[name].values)


@pytest.mark.parametrize("window_size", chip_smoke.SLICE_WINDOWS)
def test_slice_matches_jax_and_truth(projected, monkeypatch, window_size):
    monkeypatch.setenv("PYORC_TPU_ENGINE", "fused-interpret")
    monkeypatch.setenv("PYORC_TPU_SHARD", "0")  # conftest forces 8 CPU devices
    cc_t, cc_j, proj_t, proj_j = projected
    w_px = window_size + window_size % 2
    piv_t, q_t = chip_smoke.run_chain(proj_t, window_size, cc_t, {})
    assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "plain_cpu"
    piv_j, q_j = chip_smoke.run_chain(proj_j, window_size, cc_j, {})
    assert piv_pallas.KERNEL_ROUTE["piv_pairs_fused"] == "tileband_sf"
    res_t = chip_smoke.check_chain(piv_t, q_t, cc_t, w_px)
    res_j = chip_smoke.check_chain(piv_j, q_j, cc_j, w_px)
    assert piv_t["v_x"].values.shape == np.asarray(piv_j["v_x"].values).shape == (N_FRAMES - 1,) + piv_t["v_x"].values.shape[1:]
    for name in ("v_x", "v_y"):
        assert abs(res_t[name] - res_j[name]) < 2e-3
        assert abs(res_t[name] - res_t[name + "_true"]) < 0.02
    assert abs(res_t["Q"] - res_j["Q"]) < 0.01 * abs(res_j["Q"])
    assert res_t["Q"] > 0  # left-to-right section across a +x flow


def test_profile_slice_covers_every_stage():
    """The profiled slices (per-pair, multipass, non-square, ensemble, wide
    ensemble), the lazy chains over both slices' stacks and the filters and
    STIV phases report each stage once; on the CPU no device work shows. The
    lazy chains' decode, upload and ops show as spans. STIV needs the 12
    frames to find its streaks."""
    camera = {"f": 1000.0, "gcp_px": 60, "aoi_px": 100}
    # the ensemble slices at 600x800: the wide ensemble's 128 px windows need a
    # few rows of them along the transect to hold Q to the truth
    stages, spans = chip_smoke.profile_slice(
        "cpu", (H_IMG, W_IMG, N_FRAMES), (600, 800, 8), ens_camera=camera, stiv_lines=(2, 3)
    )
    chain = ("get_piv", "mask", "transect_q_flow")
    want = {"normalize", "project"} | {
        f"{name}[{ws + ws % 2}px]" for ws in chip_smoke.SLICE_WINDOWS for name in chain
    } | {f"{name}[{ws + ws % 2}px x{passes}]" for ws, passes in chip_smoke.MULTIPASS for name in chain} | {
        f"{name}[ens]" for name in ("normalize", "project", "get_piv", "mask", "transect_q_flow")
    } | {f"{name}[64x128px]" for name in chain} | {f"{name}[ens 128px]" for name in chain} | {
        "smooth", "edge_detect", "minmax", "time_diff", "reduce_rolling", "range", "project[rgb]",
        "smooth[stiv]", "get_stiv", "get_stiv[reverse]", "get_stiv[profile]",
    } | {"normalize[lazy]", "project[lazy]"} | {
        f"{name}[lazy {ws + ws % 2}px]" for ws in chip_smoke.SLICE_WINDOWS for name in chain
    } | {f"{name}[lazy ens]" for name in ("normalize", "project", "get_piv", "mask", "transect_q_flow")}
    assert set(stages) == want
    assert {"lazy:decode", "lazy:upload", "lazy:normalize", "lazy:project"} <= set(spans), spans
    for row in stages.values():
        assert row["wall_ms"] > 0 and row["device_ms"] == row["copy_ms"] == 0.0 and row["idle"] == 1.0


def test_engine_takes_tensor_stacks(projected):
    """The engine streams a stack held as a tensor like one held as numpy,
    and 5-frame chunks (one-frame overlap) give the single chunk's result."""
    from pyorc_tpu_torch import ndx

    _, _, proj_t, _ = projected
    kwargs = dict(window_size=25, overlap=(13, 13), chunksize=5)
    want = proj_t.frames.get_piv(**kwargs)
    as_tensor = ndx.DataArray(
        torch.as_tensor(proj_t.values), dims=proj_t.dims,
        coords={k: proj_t[k].values for k in ("time", "y", "x")}, attrs=dict(proj_t.attrs),
    )
    for name in ("xs", "ys"):
        as_tensor._coords[name] = proj_t._coords[name]
    got = as_tensor.frames.get_piv(**kwargs)
    whole = proj_t.frames.get_piv(window_size=25, overlap=(13, 13))
    assert want["v_x"].values.shape[0] == N_FRAMES - 1
    for name in ("v_x", "v_y", "corr", "s2n"):
        np.testing.assert_array_equal(got[name].values, want[name].values)
        np.testing.assert_array_equal(whole[name].values, want[name].values)


def test_mask_transect_discharge_identical(projected, monkeypatch):
    """Given the same PIV fields, the port's mask -> transect -> discharge
    chain (host numpy on its own ndx copy) gives the JAX package's numbers."""
    from pyorc_tpu_torch import ndx

    monkeypatch.setenv("PYORC_TPU_SHARD", "0")
    cc_t, cc_j, _, proj_j = projected
    piv_j = proj_j.frames.get_piv(window_size=25, overlap=(13, 13))
    piv_t = ndx.Dataset(
        {k: (v.dims, np.asarray(v.values), dict(v.attrs)) for k, v in piv_j.data_vars.items()},
        coords={k: (c.dims, np.asarray(c.values), dict(c.attrs)) for k, c in piv_j.coords.items()},
        attrs=dict(piv_j.attrs),
    )
    outs = []
    for piv, cc in ((piv_t, cc_t), (piv_j, cc_j)):
        masked = piv.velocimetry.mask(
            [piv.velocimetry.mask.minmax(), piv.velocimetry.mask.corr(), piv.velocimetry.mask.count()]
        )
        q = masked.velocimetry.get_transect(*chip_smoke.transect_points(cc)).transect.get_q(fill_method="interpolate")
        q.transect.get_river_flow()
        outs.append((masked, q))
    (m_t, q_t), (m_j, q_j) = outs
    for name in ("v_x", "v_y", "corr", "s2n"):
        np.testing.assert_array_equal(m_t[name].values, np.asarray(m_j[name].values))
    for name in ("v_eff", "q", "river_flow"):
        np.testing.assert_array_equal(q_t[name].values, np.asarray(q_j[name].values))


def test_non_square_chain_matches_jax(projected, monkeypatch):
    """chip_smoke's non-square path (get_piv with 64x128 px windows at overlap
    (32, 64) -> mask -> transect -> Q) against the JAX package, whose XLA
    engine computes these windows (its Pallas route raises on them, see
    tests/test_torch_piv.py). JAX's own get_q then fails to reload the
    camera config its get_piv wrote with a (y, x) window (ROADMAP C), so its
    chain continues from its PIV with the recipe's camera config. v_x / v_y
    within 2e-3 m/s, corr / s2n within 1e-3, Q within 1 %, and the port's
    medians within the smoke run's 0.02 m/s of the truth."""
    monkeypatch.setenv("PYORC_TPU_ENGINE", "xla")
    monkeypatch.setenv("PYORC_TPU_SHARD", "0")
    cc_t, cc_j, proj_t, proj_j = projected
    res_t, _, piv_t = chip_smoke.non_square_phase(proj_t, H_IMG, W_IMG)
    assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "plain_cpu"
    piv_j = proj_j.frames.get_piv(window_size=chip_smoke.NS_WINDOW, overlap=chip_smoke.NS_OVERLAP)
    assert piv_t["v_x"].values.shape == (N_FRAMES - 1, 7, 5)
    for name in ("v_x", "v_y", "corr", "s2n"):
        got, want = piv_t[name].values, np.asarray(piv_j[name].values)
        assert got.shape == want.shape
        assert (np.isnan(got) == np.isnan(want)).all(), name
        tol = 2e-3 if name.startswith("v_") else 1e-3
        np.testing.assert_allclose(got, want, atol=tol, rtol=0 if name != "s2n" else 1e-3, err_msg=name)
    with pytest.raises(AssertionError, match="window_size"):
        piv_j.velocimetry.get_transect(*chip_smoke.transect_points(cc_j)).transect.get_q(fill_method="interpolate")
    piv_j.attrs["camera_config"] = cc_j.to_json()
    mask = piv_j.velocimetry.mask
    masked = piv_j.velocimetry.mask([mask.minmax(), mask.corr(), mask.count()])
    q_j = masked.velocimetry.get_transect(*chip_smoke.transect_points(cc_j)).transect.get_q(fill_method="interpolate")
    q_j.transect.get_river_flow()
    q_median = float(q_j["river_flow"].sel(quantile=0.5).values)
    assert abs(res_t["Q"] - q_median) < 0.01 * abs(q_median)
    for name in ("v_x", "v_y"):
        assert abs(res_t[name] - res_t[name + "_true"]) < chip_smoke.NS_VEL_TOL
