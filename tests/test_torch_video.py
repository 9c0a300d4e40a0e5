"""The port's Video and lazy frame chain against the JAX package on the CPU.

Two small H.264 clips (240x320, 12 frames, crf 12; the advected texture of
``chip_smoke.advected_stack``, written with the JAX package's native
encoder: one gray, one whose bands are the texture, its negative and its
half) go through ``pyorc_tpu.Video`` and ``pyorc_tpu_torch.Video`` on both
decode back ends (the native FFmpeg pump, and OpenCV with
``PYORC_TPU_NATIVE_DECODE=0``). Metadata, frames, coords, attrs, errors and
stabilization must match; the lazy chain normalize -> project -> get_piv ->
transect -> Q must match JAX's lazy chain, and every lazy op must give the
port's in-memory result on the same frames.
"""

import numpy as np
import pytest
import torch

import pyorc_tpu
import pyorc_tpu_torch
from pyorc_tpu_torch import _device
from pyorc_tpu_torch.io import video_reader

import chip_smoke

H, W, N = 240, 320, 12
CAMERA = {"gcp_px": 30, "aoi_px": 40}
BACKENDS = {"native": "1", "cv2": "0"}


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """(gray clip, color clip, the uint8 stack written)."""
    from pyorc_tpu.io.native_decoder import NativeVideoWriter

    stack = chip_smoke.advected_stack(H, W, N, "cpu")
    folder = tmp_path_factory.mktemp("clips")
    gray, color = str(folder / "gray.mp4"), str(folder / "color.mp4")
    with NativeVideoWriter(gray, W, H, fps=chip_smoke.FPS, channels=1, crf=12) as out:
        for frame in stack:
            out.write(frame)
    with NativeVideoWriter(color, W, H, fps=chip_smoke.FPS, channels=3, crf=12) as out:
        for frame in stack:
            out.write(np.stack([frame, 255 - frame, frame // 2], axis=-1))
    return gray, color, stack


@pytest.fixture(scope="module")
def cameras():
    """(port camera config, JAX camera config): chip_smoke's nadir camera at 240x320."""
    cc_t = chip_smoke.nadir_camera_config(H, W, **CAMERA)
    return cc_t, pyorc_tpu.get_camera_config(cc_t.to_json())


def _videos(fn, cameras, **kwargs):
    cc_t, cc_j = cameras
    kwargs.setdefault("h_a", 0.0)
    return (
        pyorc_tpu_torch.Video(fn, camera_config=cc_t, progress=False, **kwargs),
        pyorc_tpu.Video(fn, camera_config=cc_j, progress=False, **kwargs),
    )


def _hold_frames(da_t, da_j):
    """Equal bytes, dims, coords and attrs."""
    np.testing.assert_array_equal(da_t.values, np.asarray(da_j.values))
    assert da_t.dims == da_j.dims
    assert set(da_t.coords) == set(da_j.coords)
    for name in da_j.coords:
        np.testing.assert_array_equal(da_t[name].values, np.asarray(da_j[name].values), err_msg=name)
    assert da_t.attrs == da_j.attrs


def _in_memory(da):
    """The same frames DataArray with its lazy data decoded into a host array."""
    new = da.copy()
    new._data = np.asarray(da.data)
    return new


def _hold_piv(got, want):
    for name in ("v_x", "v_y", "corr", "s2n"):
        np.testing.assert_array_equal(got[name].values, want[name].values, err_msg=name)


@pytest.mark.parametrize("backend", BACKENDS)
def test_metadata_matches_jax(clips, cameras, monkeypatch, backend):
    monkeypatch.setenv("PYORC_TPU_NATIVE_DECODE", BACKENDS[backend])
    for kwargs in ({}, {"start_frame": 2, "end_frame": 7}, {"end_frame": 100, "freq": 2}):
        vt, vj = _videos(clips[0], cameras, **kwargs)
        for name in ("frame_count", "fps", "time", "frame_number", "height", "width",
                     "start_frame", "end_frame", "freq", "rotation", "h_a", "chunksize"):
            assert getattr(vt, name) == getattr(vj, name), (name, kwargs)
        if "start_frame" in kwargs:  # the end frame is inclusive
            assert vt.frame_number == list(range(2, 8))
        _hold_frames(vt.get_frames(), vj.get_frames())
    assert (vt._native_reader is not None) == (backend == "native")


@pytest.mark.parametrize("workers", ["auto", "1", "3"])
def test_decode_workers_switch(clips, cameras, monkeypatch, workers):
    """PYORC_TPU_DECODE_WORKERS picks one native decoder or GOP-parallel ones ("auto": one for
    a small clip); the frames are JAX's either way (JAX's scan falls back to cv2 on "auto")."""
    monkeypatch.setenv("PYORC_TPU_DECODE_WORKERS", workers)
    vt, vj = _videos(clips[0], cameras)
    want = "ParallelVideoReader" if workers == "3" else "NativeVideoReader"
    assert type(vt._native_reader).__name__ == want
    assert vt.frame_number == vj.frame_number and vt.time == vj.time
    _hold_frames(vt.get_frames(), vj.get_frames())


@pytest.mark.parametrize("method", ["grayscale", "rgb", "bgr", "hsv"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_frames_match_jax(clips, cameras, monkeypatch, backend, method):
    monkeypatch.setenv("PYORC_TPU_NATIVE_DECODE", BACKENDS[backend])
    vt, vj = _videos(clips[1], cameras)
    da_t = vt.get_frames(method)
    assert isinstance(da_t.data, pyorc_tpu_torch.LazyFrames)
    _hold_frames(da_t, vj.get_frames(method))
    np.testing.assert_array_equal(vt.get_frame(3, method), vj.get_frame(3, method))
    np.testing.assert_array_equal(da_t.data[3], da_t.values[3])


@pytest.mark.parametrize("backend", BACKENDS)
def test_rotation_matches_jax(clips, cameras, monkeypatch, backend):
    monkeypatch.setenv("PYORC_TPU_NATIVE_DECODE", BACKENDS[backend])
    vt, vj = _videos(clips[0], cameras, rotation=90)
    da_t = vt.get_frames()
    assert da_t.shape[1:] == (W, H)
    _hold_frames(da_t, vj.get_frames())


def test_stabilize_matches_jax(clips, cameras):
    """The stabilization affines agree within 1e-6, and so do the warped frames."""
    polygon = [[100, 60], [220, 60], [220, 180], [100, 180]]
    vt, vj = _videos(clips[0], cameras, stabilize=polygon)
    np.testing.assert_array_equal(vt.mask, vj.mask)
    assert len(vt.ms) == len(vj.ms) == len(vt.frame_number)
    np.testing.assert_allclose(np.asarray(vt.ms), np.asarray(vj.ms), atol=1e-6, rtol=0)
    _hold_frames(vt.get_frames(), vj.get_frames())


@pytest.mark.parametrize("case", ["missing_file", "start_after_end"])
def test_errors_match_jax(clips, case):
    if case == "missing_file":
        fn, kwargs = "/nonexistent/clip.mp4", {}
    else:
        fn, kwargs = clips[0], {"start_frame": 5, "end_frame": 2}
    errors = []
    for pkg in (pyorc_tpu_torch, pyorc_tpu):
        with pytest.raises((IOError, ValueError)) as info:
            pkg.Video(fn, progress=False, **kwargs)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("ensemble", [False, True], ids=["pairs-16px", "ensemble-32px"])
def test_lazy_chain_matches_jax(clips, cameras, monkeypatch, ensemble):
    """Video -> normalize -> project -> get_piv -> mask -> transect -> Q, lazy in both packages:
    v_x / v_y within 2e-3 m/s, Q within 1 % (the bars of tests/test_torch_slice.py)."""
    monkeypatch.setenv("PYORC_TPU_ENGINE", "fused-interpret")
    monkeypatch.setenv("PYORC_TPU_SHARD", "0")  # conftest forces 8 CPU devices
    window = 32 if ensemble else 16
    outs = []
    for video, cc in zip(_videos(clips[0], cameras), cameras):
        proj = video.get_frames().frames.normalize(samples=4).frames.project()
        piv, q = chip_smoke.run_chain(proj, window, cc, {}, aoi_px=CAMERA["aoi_px"], ensemble=ensemble)
        outs.append((piv, q))
    (piv_t, q_t), (piv_j, q_j) = outs
    assert isinstance(proj.data, pyorc_tpu.api.video.LazyFrames)
    for name in ("v_x", "v_y"):
        got, want = piv_t[name].values, np.asarray(piv_j[name].values)
        assert got.shape == want.shape and got.shape[0] == (1 if ensemble else len(piv_t["time"]))
        assert abs(np.nanmedian(got) - np.nanmedian(want)) < 2e-3, name
        # vector by vector too, but for near-tie double peaks (parity is gap-conditioned)
        both = np.isfinite(got) & np.isfinite(want)
        assert both.mean() > 0.9 and (np.abs(got - want)[both] <= 2e-3).mean() > 0.99, name
    flow_t, flow_j = q_t["river_flow"], q_j["river_flow"]
    q_t = float(flow_t.sel(quantile=0.5).values) if "quantile" in flow_t.dims else float(flow_t.values)
    q_j = float(flow_j.sel(quantile=0.5).values) if "quantile" in flow_j.dims else float(flow_j.values)
    assert q_t > 0 and abs(q_t - q_j) < 0.01 * abs(q_j)


CHAINS = {
    "normalize": lambda f: f.normalize(samples=4),
    "raw": lambda f: f._obj,
    "smooth": lambda f: f.smooth(wdw=1),
    "edge_detect": lambda f: f.edge_detect(wdw_1=1, wdw_2=2),
    "minmax": lambda f: f.minmax(min=40.0, max=200.0),
    "minmax-smooth": lambda f: f.minmax(min=40.0).frames.smooth(wdw=2),
}


@pytest.mark.parametrize("crop", [True, False], ids=["crop", "no-crop"])
@pytest.mark.parametrize("chain", CHAINS)
def test_lazy_chain_equals_in_memory(clips, cameras, monkeypatch, chain, crop):
    """Each filter -> project -> get_piv on the lazy stack gives the in-memory chain's
    frames and PIV to the bit, with the upload crop on or off. Ops with a stencil
    halo are cropped on the host before the upload; normalize needs whole frames."""
    monkeypatch.setenv("PYORC_TPU_NO_UPLOAD_CROP", "0" if crop else "1")
    vt, _ = _videos(clips[0], cameras)
    lazy = vt.get_frames()
    outs = []
    for da in (lazy, _in_memory(lazy)):
        filtered = CHAINS[chain](da.frames)
        proj = filtered.frames.project()
        outs.append((proj, proj.frames.get_piv(window_size=16, overlap=(8, 8))))
    (proj_l, piv_l), (proj_m, piv_m) = outs
    data = proj_l.data
    assert isinstance(data, pyorc_tpu_torch.LazyFrames)
    assert (data._crop is not None) == (crop and chain != "normalize")
    if data._crop is not None:
        r0, r1, c0, c1 = data._crop
        assert (r1 - r0) * (c1 - c0) < 0.8 * H * W
    assert proj_l.dtype == proj_m.dtype and proj_l.shape == proj_m.shape
    np.testing.assert_array_equal(proj_l.values, proj_m.values)
    _hold_piv(piv_l, piv_m)


@pytest.mark.parametrize("crop", [True, False], ids=["crop", "no-crop"])
def test_lazy_rgb_project_equals_in_memory(clips, cameras, monkeypatch, crop):
    """get_frames("rgb") -> project runs band by band on the chain (dims (time, y, x, rgb)) and
    gives the in-memory projection, cropped before the upload or not; JAX's RGB projection too."""
    monkeypatch.setenv("PYORC_TPU_NO_UPLOAD_CROP", "0" if crop else "1")
    vt, vj = _videos(clips[1], cameras)
    lazy = vt.get_frames("rgb")
    proj_l, proj_m = lazy.frames.project(), _in_memory(lazy).frames.project()
    assert isinstance(proj_l.data, pyorc_tpu_torch.LazyFrames) and (proj_l.data._crop is not None) == crop
    assert proj_l.dims == proj_m.dims == ("time", "y", "x", "rgb")
    np.testing.assert_array_equal(proj_l.values, proj_m.values)
    np.testing.assert_array_equal(proj_l.values, np.asarray(vj.get_frames("rgb").frames.project().values))


@pytest.mark.parametrize("method", ["range", "time_diff", "reduce_rolling", "get_stiv", "get_piv-passes3"])
def test_lazy_stack_ops_equal_in_memory(clips, cameras, method):
    """The ops over time (range, time_diff, reduce_rolling), get_stiv and multipass get_piv
    read the lazy chain's device batches and give the in-memory result."""
    vt, _ = _videos(clips[0], cameras)
    proj = vt.get_frames().frames.normalize(samples=4).frames.project()
    cc = cameras[0]
    vx, vy = chip_smoke.expected_velocity(cc)
    angle = float(np.arctan2(vy, vx))
    calls = {
        "range": lambda f: f.range(),
        "time_diff": lambda f: f.time_diff(thres=2.0, abs=True),
        "reduce_rolling": lambda f: f.reduce_rolling(samples=4),
        "get_stiv": lambda f: f.smooth(wdw=2).frames.get_stiv(
            chip_smoke.stiv_lines_inside(f._obj, angle, 0.6, (2, 2)), angle, 0.6, n_samples=31
        ),
        "get_piv-passes3": lambda f: f.get_piv(window_size=16, overlap=(8, 8), passes=3),
    }
    got, want = calls[method](proj.frames), calls[method](_in_memory(proj).frames)
    if isinstance(want, pyorc_tpu_torch.Dataset):
        for name in want.data_vars:
            np.testing.assert_array_equal(got[name].values, want[name].values, err_msg=name)
        return
    assert got.dims == want.dims and got.dtype == want.dtype
    np.testing.assert_array_equal(got.values, want.values)
    assert ("time" in got.dims) == ("time" in want.dims)
    if "time" in want.dims:
        np.testing.assert_array_equal(got["time"].values, want["time"].values)


def test_lazy_chain_moves_frames_once(clips, cameras):
    """normalize and project download nothing; get_piv uploads each decoded frame once
    (the frame two batches share is reused on the device, not decoded again) and
    downloads its outputs only."""
    vt, _ = _videos(clips[0], cameras)
    proj = vt.get_frames().frames.normalize(samples=4).frames.project()
    n = proj.shape[0]
    _device.COPY_BYTES.update(h2d=0, d2h=0)
    piv = proj.frames.get_piv(window_size=16, overlap=(8, 8), chunksize=6)
    n_out = 4 * 4 * (n - 1) * piv["v_x"].shape[1] * piv["v_x"].shape[2]
    assert _device.COPY_BYTES == {"h2d": n * H * W, "d2h": n_out}


def test_lazy_chunks_carry_the_kernels_halo(clips, cameras):
    """The engine's chunks of a lazy stack are those of the same stack in memory:
    the same frames, first frame and halo (the batches overlap by four frames,
    decoded once)."""
    from pyorc_tpu_torch.velocimetry import engine

    vt, _ = _videos(clips[0], cameras)
    lazy = vt.get_frames().frames.normalize(samples=4).data
    mem = np.asarray(lazy)
    for chunksize in (3, 5, 6, 40):
        got, want = list(engine._iter_chunks(lazy, chunksize)), list(engine._iter_chunks(mem, chunksize))
        assert [(g.frame0, g.halo) for g in got] == [(w.frame0, w.halo) for w in want]
        assert sum(w.n_pairs for w in want) == mem.shape[0] - 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_device.to_host(g.frames), w.frames)


def test_upload_crop_switch_is_a_boolean(monkeypatch):
    from pyorc_tpu_torch.api import frames

    for value, on in (("", True), ("0", True), ("false", True), ("1", False), ("TRUE", False), ("yes", False)):
        monkeypatch.setenv("PYORC_TPU_NO_UPLOAD_CROP", value)
        assert frames._upload_crop_on() is on, value
    monkeypatch.setenv("PYORC_TPU_NO_UPLOAD_CROP", "perhaps")
    with pytest.raises(ValueError, match="PYORC_TPU_NO_UPLOAD_CROP"):
        frames._upload_crop_on()


class _Recorded(video_reader.BatchPrefetcher):
    made = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _Recorded.made.append(self)


def test_prefetch_worker_joined_when_iteration_stops_early(clips, cameras, monkeypatch):
    monkeypatch.setattr(video_reader, "BatchPrefetcher", _Recorded)
    _Recorded.made.clear()
    vt, _ = _videos(clips[0], cameras)
    lazy = vt.get_frames().frames.smooth().data
    batches = lazy.iter_batches(2, prefetch=1)
    start, first = next(batches)
    assert start == 0 and first.shape == (2, H, W)
    (fetcher,) = _Recorded.made
    batches.close()
    assert not fetcher.alive
    for _, _ in lazy.iter_batches(3):
        break
    assert not _Recorded.made[-1].alive


def test_prefetch_forwards_worker_errors(clips, cameras):
    vt, _ = _videos(clips[0], cameras)
    lazy = vt.get_frames().data

    def broken(*_):
        raise OSError("decode failed")

    lazy._video = type("Broken", (), {"_decode_frames": broken, "fn": "broken"})()
    with pytest.raises(OSError, match="decode failed"):
        list(lazy.iter_batches(4))


def test_chip_smoke_video_chain(monkeypatch):
    """chip_smoke's video chain as the card runs it (OpenCV decode): a lossless FFV1 clip of the
    slice's stack through pyorc_tpu_torch.Video gives the in-memory slice's PIV to the bit."""
    monkeypatch.setenv("PYORC_TPU_NATIVE_DECODE", "0")
    assert chip_smoke.decoder_probe()["cv2_video_io"] == "FFV1 round trip exact"
    stack = chip_smoke.advected_stack(480, 640, 12, "cpu")
    _, _, _, pivs = chip_smoke.slice_phase(480, 640, 12, "cpu", stack=stack)
    clip = chip_smoke.write_clip(stack, chip_smoke.ROOT / "build" / "test_video_chain.avi")
    try:
        results, _, rows, _ = chip_smoke.lazy_phase(
            stack, chip_smoke.nadir_camera_config(480, 640), pivs, "cpu", tag="video", video_file=clip
        )
    finally:
        clip.unlink()
    assert set(results) == {16, 26}
    assert all(d == 0.0 for r in results.values() for d in r["max_abs_diff_vs_in_memory"].values()), results
    assert rows["get_piv[video 16px]"]["h2d"] == stack.nbytes and rows["get_piv[video 16px]"]["source_s"] > 0
