"""The port's multi-device layer (pyorc_tpu_torch.parallel and the engine's mesh routes)
against the JAX package's on the CPU.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``; the port on a mesh
of 8 CPU shards (``[cpu] * 8``, or ``PYORC_TPU_CPU_DEVICES=8`` for the engine and the
frame filters). The frame stack is ``tests/test_parallel.py``'s (128x160, 11 frames:
10 pairs over 8 shards, an uneven split), the tolerances are that file's. Where the
two packages' contracts differ (the kernel's NaN and s2n at zero-variance windows),
u and v are held on windows whose top-2 correlation peaks differ by more than 5e-3,
as in ``tests/test_torch_piv.py``. The two-process runs start at most two children,
each with a timeout.
"""

import json

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from pyorc_tpu import ndx as jndx
from pyorc_tpu import parallel as jparallel
from pyorc_tpu.ops import piv_pallas
from pyorc_tpu.parallel import distributed as jdist
from pyorc_tpu.velocimetry import engine as jeng

import pyorc_tpu_torch
from pyorc_tpu_torch import _device
from pyorc_tpu_torch import ndx as tndx
from pyorc_tpu_torch import parallel as tparallel
from pyorc_tpu_torch.ops import piv as tpiv
from pyorc_tpu_torch.ops import piv_kernels
from pyorc_tpu_torch.ops import windows as twin
from pyorc_tpu_torch.parallel import distributed as tdist
from pyorc_tpu_torch.parallel import piv as tppiv
from pyorc_tpu_torch.velocimetry import engine as teng

import chip_smoke
from test_piv import make_particle_image, shift_image

CPU8 = [torch.device("cpu")] * 8
DIMS = (128, 160)


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)
    for name in ("PYORC_TPU_SHARD", "PYORC_TPU_ENGINE", "PYORC_TPU_MESH2D", "PYORC_TPU_CPU_DEVICES"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def frame_stack():
    rng = np.random.default_rng(7)
    base = make_particle_image(rng, *DIMS)
    frames = [base]
    for t in range(1, 11):  # 10 pairs over 8 devices -> uneven split
        frames.append(shift_image(base, 1.5 * t, -0.8 * t))
    return np.stack(frames).astype(np.float32)


def _gap(imgs, sas, overlap):
    n_rows, n_cols = twin.get_field_shape(imgs.shape[-2:], sas, overlap)
    gap = tpiv.top2_gap(torch.as_tensor(imgs), imgs.shape[-2:], sas, overlap)
    return gap.reshape(-1, n_rows, n_cols).numpy()


def _hold_pairs(got, want, gap, tol=1e-4):
    """NaN masks equal; u, v within ``tol`` on windows with a top-2 gap > 5e-3; cmax 1e-4, s2n 1e-3."""
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    confident = (gap > 5e-3) & ~np.isnan(want[0])
    assert confident.mean() > 0.9
    for g, w in zip(got[:2], want[:2]):
        assert np.abs(g - w)[confident].max() <= tol
    np.testing.assert_allclose(got[2], want[2], atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], atol=1e-3, rtol=1e-3)


def test_local_devices_and_mesh(monkeypatch):
    assert _device.local_devices() == [torch.device("cpu")]
    monkeypatch.setenv("PYORC_TPU_CPU_DEVICES", "8")
    assert _device.local_devices() == CPU8
    assert tparallel.make_mesh().shape == {"pairs": 8}
    monkeypatch.setenv("PYORC_TPU_SHARD", "0")
    assert _device.local_devices() == [torch.device("cpu")]
    mesh = tppiv.Mesh(np.asarray(CPU8, dtype=object).reshape(4, 2), ("pairs", "rows"))
    assert mesh.shape == {"pairs": 4, "rows": 2} and mesh.devices[3, 1] == torch.device("cpu")
    with pytest.raises(ValueError, match="axis names"):
        tppiv.Mesh(CPU8, ("pairs", "rows"))


@pytest.mark.parametrize("n_frames,n_dev,zero_pad", [(11, 8, False), (11, 8, True), (7, 3, False), (9, 4, True)])
def test_pad_helpers_equal_jax(rng, n_frames, n_dev, zero_pad):
    imgs = rng.normal(size=(n_frames, 40, 24)).astype(np.float32)
    got, n = tppiv.pad_pairs_for_devices(imgs, n_dev, zero_pad)
    want, m = jparallel.piv.pad_pairs_for_devices(imgs, n_dev, zero_pad)
    assert n == m and np.array_equal(got, want)
    got, nb = tppiv.pad_rows_for_devices(imgs, 2, 16, 8, 4)  # 4 window rows of 16 px at step 8: 40 px
    want, mb = jparallel.piv.pad_rows_for_devices(imgs, 2, 16, 8, 4)
    assert nb == mb and np.array_equal(got, want)
    got, nb = tppiv.pad_rows_for_devices(imgs, 3, 16, 8, 4)  # padded with zero rows
    want, mb = jparallel.piv.pad_rows_for_devices(imgs, 3, 16, 8, 4)
    assert nb == mb and np.array_equal(got, want)


@pytest.mark.parametrize("engine", ["xla", "fused-interpret"])
def test_pairs_sharded_matches_jax(frame_stack, engine):
    imgs = frame_stack
    got = tparallel.piv_pairs_sharded(imgs, (32, 32), (16, 16), mesh=tparallel.make_mesh(CPU8), engine=engine)
    want = [np.asarray(a) for a in jparallel.piv_pairs_sharded(imgs, (32, 32), (16, 16), engine=engine)]
    assert got[0].shape == (10, 7, 9)
    _hold_pairs(got, want, _gap(imgs, (32, 32), (16, 16)))
    # and the sharded port is the one-device port: each pair is computed alone
    one = piv_kernels.piv_pairs_engine(engine)(torch.as_tensor(imgs), DIMS, (32, 32), (16, 16), 7, 9)
    for g, o in zip(got, one):
        np.testing.assert_allclose(g, o.numpy(), atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("sas", [(32, 32), (16, 16)], ids=["32px", "16px"])
def test_ensemble_sharded_matches_jax(frame_stack, sas):
    imgs = frame_stack
    overlap = (sas[0] // 2, sas[1] // 2)
    mesh = tparallel.make_mesh(CPU8)
    cs, cc, cm, s2 = tparallel.piv_ensemble_sharded(
        imgs, sas, overlap, mesh=mesh, corr_min=0.1, s2n_min=1.5, engine="fused-interpret"
    )
    jcs, jcc, jcm, js2 = (np.asarray(a) for a in jparallel.piv_ensemble_sharded(
        imgs, sas, overlap, corr_min=0.1, s2n_min=1.5, engine="fused-interpret"))
    assert cm.shape == jcm.shape == (10,) + twin.get_field_shape(DIMS, sas, overlap)
    np.testing.assert_array_equal(cc, jcc)
    np.testing.assert_allclose(cs, jcs, atol=2e-3)
    np.testing.assert_allclose(cm, jcm, atol=1e-4)
    np.testing.assert_allclose(s2, js2, atol=1e-3, rtol=1e-3)
    # the XLA scan of both packages
    got = tparallel.piv_ensemble_sharded(imgs, sas, overlap, mesh=mesh, corr_min=0.1, s2n_min=1.5, engine="xla")
    want = [np.asarray(a) for a in jparallel.piv_ensemble_sharded(imgs, sas, overlap, corr_min=0.1, s2n_min=1.5)]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=2e-3)
    # open gates: no pair is padded, so the counts are the one-device counts exactly
    n_rows, n_cols = twin.get_field_shape(DIMS, sas, overlap)
    one = piv_kernels.piv_ensemble_fused_plain(torch.as_tensor(imgs), DIMS, sas, overlap, n_rows, n_cols, 0.0, 0.0)
    got = tparallel.piv_ensemble_sharded(imgs, sas, overlap, mesh=mesh, corr_min=0.0, s2n_min=0.0)
    np.testing.assert_array_equal(got[1], one[1].numpy())
    assert (got[1] == 10).all()
    np.testing.assert_allclose(got[0], one[0].numpy(), atol=1e-5)


def test_multipass_sharded_matches_jax(rng):
    img = make_particle_image(rng, 96, 160)
    imgs = np.stack([shift_image(img, 1.3 * t, -0.8 * t) for t in range(6)]).astype(np.float32)
    got = tparallel.piv_multipass_sharded(imgs, (32, 32), (16, 16), mesh=tparallel.make_mesh(CPU8[:4]), passes=2)
    want = jparallel.piv_multipass_sharded(
        imgs, (32, 32), (16, 16), mesh=jparallel.make_mesh(jax.devices()[:4]), passes=2
    )
    assert got[0].shape == np.asarray(want[0]).shape == (5, 5, 9)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-3, equal_nan=True)


def test_pairs_sharded_2d_matches_jax(rng):
    img = make_particle_image(rng, 160, 192)
    imgs = np.stack([shift_image(img, 1.5 * t, -t) for t in range(5)]).astype(np.float32)
    mesh = tppiv.Mesh(np.asarray(CPU8, dtype=object).reshape(4, 2), ("pairs", "rows"))
    got = tparallel.piv_pairs_sharded_2d(imgs, (32, 32), (16, 16), mesh=mesh, engine="xla")
    jmesh = JMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("pairs", "rows"))
    want = [np.asarray(a) for a in jparallel.piv_pairs_sharded_2d(imgs, (32, 32), (16, 16), mesh=jmesh)]
    assert got[0].shape == want[0].shape == (4, 9, 11)
    _hold_pairs(got, want, _gap(imgs, (32, 32), (16, 16)))
    # row slabs with zero rows below the frame (3 slabs of 3 window rows for 9) are the one-device field
    mesh = tppiv.Mesh(np.asarray(CPU8[:6], dtype=object).reshape(2, 3), ("pairs", "rows"))
    got = tparallel.piv_pairs_sharded_2d(imgs, (32, 32), (16, 16), mesh=mesh)
    one = piv_kernels.piv_pairs_routed(torch.as_tensor(imgs), (160, 192), (32, 32), (16, 16), 9, 11)
    for g, o in zip(got, one):
        np.testing.assert_allclose(g, o.numpy(), atol=1e-6, equal_nan=True)
    with pytest.raises(ValueError, match="uniform strided"):
        tparallel.piv_pairs_sharded_2d(imgs, (32, 32), (12, 12), mesh=mesh)  # a step of 20 does not divide 32


def test_plan_mesh2d_equals_jax(monkeypatch):
    cases = [(64, 30, 8), (3, 30, 8), (1, 30, 8), (1, 4, 8), (1, 30, 1), (5, 30, 8), (2, 3, 4)]
    for env in (None, "auto", "4", "0", "3", "2"):
        if env is None:
            monkeypatch.delenv("PYORC_TPU_MESH2D", raising=False)
        else:
            monkeypatch.setenv("PYORC_TPU_MESH2D", env)
        for case in cases:
            assert teng._plan_mesh2d(*case) == jeng._plan_mesh2d(*case), (env, case)
    monkeypatch.setenv("PYORC_TPU_MESH2D", "auto")  # non-integer -> auto (tests/test_parallel.py:318-329)
    assert teng._plan_mesh2d(64, 30, 8) is None and teng._plan_mesh2d(1, 30, 8) == (1, 8)


def test_distributed_helpers_equal_jax(tmp_path):
    for n_frames, nproc in [(101, 4), (10, 2), (7, 3), (3, 4), (126, 2)]:
        assert tdist.segment_frame_ranges(n_frames, nproc) == jdist.segment_frame_ranges(n_frames, nproc)
    videos = [f"v{i}.mp4" for i in range(5)]
    for pid in range(3):
        assert tdist.host_video_assignment(videos, pid, 3) == jdist.host_video_assignment(videos, pid, 3)
    segs = tdist.segment_frame_ranges(10, 2)

    def entry(i, s, e):
        return {"prefix": f"run1_host{i:03d}_", "artifact": f"run1_host{i:03d}_piv.nc"}

    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tdist.write_segments_manifest(tmp_path / "t", 10, segs, entry)
    jdist.write_segments_manifest(tmp_path / "j", 10, segs, entry)
    assert (tmp_path / "t" / "manifest.json").read_text() == (tmp_path / "j" / "manifest.json").read_text()
    done = []
    outs = tdist.process_videos_multihost(
        videos, lambda v, o: done.append(v) or open(o, "w").write("x"), str(tmp_path / "v"),
        process_id=0, num_processes=1,
    )
    assert len(outs) == 5 and done == videos
    assert json.loads((tmp_path / "v" / "manifest.json").read_text()) == {"num_processes": 1, "videos": {"0": videos}}


def test_init_distributed_single_process():
    assert tdist.init_distributed() == (0, 1)
    assert not torch.distributed.is_initialized()
    tdist.barrier()  # one process: nothing to wait for


def test_two_process_segments_match_single_and_jax(tmp_path, rng):
    """Two processes (chip_smoke's segment worker, gloo over 127.0.0.1) run
    process_segments_multihost; their segments stitched in pair order equal the
    one-process port and JAX's kernel (interpret mode)."""
    img = make_particle_image(rng, 96, 128)
    frames = np.stack([shift_image(img, 1.4 * t, -0.9 * t) for t in range(7)]).astype(np.float32)
    wall, stitched, launches, manifest = chip_smoke.two_process_segments(frames, tmp_path, 32, "cpu")
    assert manifest["segments"] == {"0": {"start_frame": 0, "end_frame": 4, "artifact": "segment_000_piv.nc"},
                                    "1": {"start_frame": 3, "end_frame": 7, "artifact": "segment_001_piv.nc"}}
    one = piv_kernels.piv_pairs_fused(torch.as_tensor(frames), (96, 128), (32, 32), (16, 16), 5, 7)
    for s, o in zip(stitched, one):
        np.testing.assert_allclose(s, o.numpy(), atol=1e-5, equal_nan=True)
    want = [np.asarray(a) for a in piv_pallas.piv_pairs_fused(
        frames, (96, 128), (32, 32), (16, 16), 5, 7, interpret=True)]
    _hold_pairs(stitched, want, _gap(frames, (32, 32), (16, 16)))


def _dataarrays(imgs):
    h, w = imgs.shape[-2:]
    coords = {"time": np.arange(imgs.shape[0], dtype=np.float64), "y": np.arange(h, dtype=np.float64),
              "x": np.arange(w, dtype=np.float64)}
    return tuple(pkg.DataArray(imgs, dims=("time", "y", "x"), coords=coords) for pkg in (tndx, jndx))


@pytest.mark.parametrize("route", ["pairs", "pairs-2d", "multipass", "ensemble"])
def test_engine_mesh_routes(rng, monkeypatch, route):
    """get_piv through the engine on 8 CPU shards equals the one-device port and JAX's engine (8 devices)."""
    n_frames = 4 if route == "pairs-2d" else 11
    img = make_particle_image(rng, 160, 192)
    imgs = np.stack([shift_image(img, 1.5 * t, -t) for t in range(n_frames)]).astype(np.float32)
    n_rows, n_cols = twin.get_field_shape((160, 192), (32, 32), (16, 16))
    y, x = np.arange(n_rows, dtype=np.float64), np.arange(n_cols, dtype=np.float64)
    kwargs = dict(ensemble_corr=route == "ensemble", passes=2 if route == "multipass" else 1)
    da_t, da_j = _dataarrays(imgs)

    def port():
        return teng.get_piv(da_t, y, x, da_t["time"].diff(dim="time"), (32, 32), (16, 16), (32, 32), 1.0, 1.0,
                            chunksize=12, **kwargs)

    one = port()
    calls = []
    real = {name: getattr(tparallel, name) for name in ("piv_pairs_sharded", "piv_pairs_sharded_2d",
                                                        "piv_multipass_sharded", "piv_ensemble_sharded")}
    for name, fn in real.items():
        monkeypatch.setattr(tparallel, name, lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    monkeypatch.setenv("PYORC_TPU_CPU_DEVICES", "8")
    sharded = port()
    expected = {"pairs": "piv_pairs_sharded", "pairs-2d": "piv_pairs_sharded_2d",
                "multipass": "piv_multipass_sharded", "ensemble": "piv_ensemble_sharded"}[route]
    assert calls == [expected]
    want = jeng.get_piv(da_j, y, x, da_j["time"].diff(dim="time"), (32, 32), (16, 16), (32, 32), 1.0, 1.0,
                        chunksize=12, **kwargs)
    for name in ("v_x", "v_y", "corr", "s2n"):
        got = sharded[name].values
        # the ensemble's planes are added in another order (per shard, then across shards)
        np.testing.assert_allclose(got, one[name].values, atol=1e-5 if route == "ensemble" else 1e-6,
                                   equal_nan=True, err_msg=name)
        tol = {"corr": 1e-4, "s2n": 1e-3}.get(name, 1e-3 if route == "multipass" else 1e-4)
        np.testing.assert_allclose(got, np.asarray(want[name].values), atol=tol, rtol=1e-3 if name == "s2n" else 0,
                                   equal_nan=True, err_msg=name)


def test_frame_ops_time_sharded(monkeypatch):
    """normalize and project on 8 CPU shards split each batch along time and give the one-device frames."""
    cc = chip_smoke.nadir_camera_config(120, 160, gcp_px=20, aoi_px=25)
    stack = chip_smoke.advected_stack(120, 160, 16, "cpu")
    da = chip_smoke.frames_dataarray(stack, cc)
    one = da.frames.normalize(samples=4).frames.project()
    calls = []
    real = pyorc_tpu_torch.api.frames._time_sharded
    monkeypatch.setattr(pyorc_tpu_torch.api.frames, "_time_sharded",
                        lambda fn, chunk, devices: calls.append(len(devices)) or real(fn, chunk, devices))
    monkeypatch.setenv("PYORC_TPU_CPU_DEVICES", "8")
    sharded = da.frames.normalize(samples=4).frames.project()
    assert calls == [8, 8]
    np.testing.assert_array_equal(sharded.values, one.values)


def test_no_corr_method_and_no_engine_variable(frame_stack, monkeypatch):
    """The port's sharded functions take no ``corr_method`` (one formulation, torch.fft), so a
    forced method cannot turn ``engine="fused"`` into another engine; and the engine reads no
    ``PYORC_TPU_ENGINE`` (the JAX package's variable): its mesh routes run the plan."""
    mesh = tparallel.make_mesh(CPU8)
    for fn in (tparallel.piv_pairs_sharded, tparallel.piv_ensemble_sharded, tparallel.piv_multipass_sharded):
        with pytest.raises(TypeError, match="corr_method"):
            fn(frame_stack, (32, 32), (16, 16), mesh=mesh, engine="fused", corr_method="fft")
    da_t, _ = _dataarrays(frame_stack)
    y, x = np.arange(7, dtype=np.float64), np.arange(9, dtype=np.float64)
    monkeypatch.setenv("PYORC_TPU_CPU_DEVICES", "8")
    monkeypatch.setenv("PYORC_TPU_ENGINE", "fused")  # would raise on CPU shards if the port read it
    piv = teng.get_piv(da_t, y, x, da_t["time"].diff(dim="time"), (32, 32), (16, 16), (32, 32), 1.0, 1.0)
    assert piv_kernels.KERNEL_ROUTE["piv_pairs_fused"] == "plain_cpu"
    assert piv["v_x"].shape == (10, 7, 9)


def test_failures_raise(frame_stack, monkeypatch):
    """A failing shard raises, and engine="fused" off the card raises: no path switches engine."""
    mesh = tparallel.make_mesh(CPU8)
    with pytest.raises(RuntimeError, match='engine="fused"'):
        tparallel.piv_pairs_sharded(frame_stack, (32, 32), (16, 16), mesh=mesh, engine="fused")
    with pytest.raises(RuntimeError, match='engine="fused"'):
        tparallel.piv_ensemble_sharded(frame_stack, (32, 32), (16, 16), mesh=mesh, engine="fused")
    with pytest.raises(ValueError, match="engine must be one of"):
        tparallel.piv_pairs_sharded(frame_stack, (32, 32), (16, 16), mesh=mesh, engine="jax")
    calls = []
    real = piv_kernels.piv_pairs_routed

    def third_fails(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("shard 2 failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(piv_kernels, "piv_pairs_routed", third_fails)
    with pytest.raises(RuntimeError, match="shard 2 failed"):
        tparallel.piv_pairs_sharded(frame_stack, (32, 32), (16, 16), mesh=mesh)


def test_profile_writes_trace(tmp_path, monkeypatch, frame_stack):
    """PYORC_TPU_PROFILE=<dir>: the PIV loop runs under torch.profiler and a Chrome trace lands in <dir>."""
    monkeypatch.setenv("PYORC_TPU_PROFILE", str(tmp_path / "trace"))
    da_t, _ = _dataarrays(frame_stack)
    y, x = np.arange(7, dtype=np.float64), np.arange(9, dtype=np.float64)
    teng.get_piv(da_t, y, x, da_t["time"].diff(dim="time"), (32, 32), (16, 16), (32, 32), 1.0, 1.0)
    traces = list((tmp_path / "trace").glob("piv_trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("fft" in str(e.get("name", "")) for e in events)


def test_chip_smoke_multidevice_step_on_cpu(tmp_path):
    """chip_smoke's step 5g (without its CLI part, rehearsed in tests/test_torch_service.py)
    at a small size on the CPU: 4 virtual shards, every check of (b)-(g)."""
    cc = chip_smoke.nadir_camera_config(240, 320, gcp_px=30, aoi_px=40)
    stack = chip_smoke.advected_stack(240, 320, 12, "cpu")  # 12 frames: batches split over 4 shards
    raw = chip_smoke.frames_dataarray(stack, cc)
    proj = raw.frames.normalize(samples=5).frames.project()
    piv26 = proj.frames.get_piv(window_size=25, overlap=(13, 13))  # as step 4 calls it
    mp_piv32 = proj.frames.get_piv(window_size=32, overlap=(16, 16), passes=3)  # as step 6 calls it
    results, walls, launches = chip_smoke.multidevice_phase(proj, piv26, mp_piv32, None, "cpu", tmp_path,
                                                            raw=raw, samples=5)
    assert results["mesh"] == "4 virtual shards of cpu"
    assert set(launches) == {"sharded per-pair 16 px", "sharded per-pair 26 px", "sharded multipass 32 px x3",
                             f"sharded 2-D {chip_smoke.MESH2D} 32 px", "engine route get_piv 26 px",
                             "two processes: segments 26 px"}
    assert all(results[k]["max_abs_duv_px"] <= chip_smoke.SHARD_TOL for k in launches), results
    assert all(results[k]["confident_share"] >= chip_smoke.SHARD_CONFIDENT_MIN for k in launches), results
    assert results["time-sharded normalize -> project"] == {
        "frames": "equal", "shards_per_batch": {"normalize": [4], "project": [4]}}
    # a check that a sharded run fails: one confident window moved, or too few confident windows
    want = [np.zeros((4, 10, 10), np.float32) for _ in range(4)]
    got = [a.copy() for a in want]
    got[0][0, 0, 0] = 0.5
    with pytest.raises(AssertionError, match="sharded vs unsharded"):
        chip_smoke.hold_sharded(got, want, "moved", gap=np.ones((4, 10, 10)))
    with pytest.raises(AssertionError, match="sharded vs unsharded"):
        chip_smoke.hold_sharded(want, want, "no confident windows", gap=np.zeros((4, 10, 10)))
