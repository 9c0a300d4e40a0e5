"""The port's exports against the JAX package on the CPU: GeoTIFF (``io/geotiff.py``,
``Frames.to_geotiff(s)``, ``cli_utils.parse_geotiff``), ``project.py``, ``Frames.to_video``
and ``to_ani``, and ``sample_data``.

The scene is a small nadir camera with a CRS (UTM 31N) over the advected texture of
``chip_smoke.advected_stack``. Files written by the two packages from the same frames are
compared byte for byte; the frames handed to a video writer are recorded in both packages
(each package's ``NativeVideoWriter`` swapped for a recorder) and compared exactly, for
the edge cases of the uint8 cast: NaN pixels, an all-NaN frame, a constant frame of -5.0,
values outside [0, 255] and RGB. A lazy stack must decode and upload each frame once and
download only the uint8 frames.
"""

import json
import logging
import os
import warnings

import numpy as np
import pytest
import torch

import pyorc_tpu
from pyorc_tpu.cli import cli_utils as jcli
from pyorc_tpu.io import native_decoder as jnative

import pyorc_tpu_torch
from pyorc_tpu_torch import _device
from pyorc_tpu_torch.cli import cli_utils as tcli
from pyorc_tpu_torch.io import native_decoder as tnative
from pyorc_tpu_torch.ops import filters as tflt

import chip_smoke

H, W, N = 96, 128, 6
X0, Y0 = 500000.0, 5700000.0  # UTM 31N, near 3 E 51.4 N


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


def crs_camera_config(h=H, w=W, gcp_px=12, aoi_px=16):
    """``chip_smoke.nadir_camera_config`` placed at (X0, Y0) in EPSG:32631, as the port's CameraConfig."""
    cc = chip_smoke.nadir_camera_config(h, w, gcp_px=gcp_px, aoi_px=aoi_px)
    d = json.loads(cc.to_json())
    d["crs"] = 32631
    d["gcps"]["dst"] = [[X0 + x, Y0 + y] for x, y in d["gcps"]["dst"]]
    d.pop("bbox", None)
    out = pyorc_tpu_torch.CameraConfig(**{k: v for k, v in d.items() if k != "is_nadir"})
    a = aoi_px
    out.set_bbox_from_corners([[a, a], [w - a, a], [w - a, h - a], [a, h - a]])
    return out


@pytest.fixture(scope="module")
def scene():
    pyorc_tpu_torch.set_device("cpu")
    cc = crs_camera_config()
    stack = chip_smoke.advected_stack(H, W, N, "cpu")
    frames = {pkg.__name__: chip_smoke.frames_dataarray(stack, cc, pkg=pkg) for pkg in (pyorc_tpu_torch, pyorc_tpu)}
    proj = {name: da.frames.project() for name, da in frames.items()}
    return {"cc": cc, "stack": stack, "frames": frames, "proj": proj}


class _Source(chip_smoke.HostFrameSource):
    """A host frame source that records each position it decodes."""

    def __init__(self, stack):
        super().__init__(stack)
        self.decoded = []

    def _decode_frames(self, positions, method):
        self.decoded.extend(np.atleast_1d(positions).tolist())
        return super()._decode_frames(positions, method)


def _lazy(stack, cc):
    source = _Source(stack)
    return source, chip_smoke.lazy_dataarray(source, cc)


# -- GeoTIFF and project.py ------------------------------------------------------


def test_write_geotiff_bytes_equal(tmp_path):
    """``io/geotiff.py`` writes the JAX package's bytes for every sample format, bands and options."""
    from pyorc_tpu.io import geotiff as jgeo

    from pyorc_tpu_torch import io as tio

    rng = np.random.default_rng(1)
    transform = (0.01, 0.0, X0, 0.0, -0.01, Y0)
    cases = [(rng.integers(0, 256, (17, 23), dtype=np.uint8), {}),
             (rng.normal(size=(9, 11, 3)).astype(np.float32), {"nodata": -9999.0}),
             (rng.integers(-500, 500, (8, 5), dtype=np.int16), {"compress": "deflate", "crs": 32631})]
    for i, (data, kwargs) in enumerate(cases):
        got, want = tmp_path / f"t{i}.tif", tmp_path / f"j{i}.tif"
        tio.to_geotiff(got, data, transform, **kwargs)
        jgeo.write_geotiff(want, data, transform, **kwargs)
        assert got.read_bytes() == want.read_bytes(), kwargs


def test_to_geotiff_equals_jax(scene, tmp_path):
    """``Frames.to_geotiff`` of a projected frame: the JAX package's file, byte for byte;
    unprojected frames raise ``ValueError`` (the JAX package asserts)."""
    tproj, jproj = scene["proj"]["pyorc_tpu_torch"], scene["proj"]["pyorc_tpu"]
    np.testing.assert_array_equal(tproj.values, np.asarray(jproj.values))
    for frame in (0, 3):
        tproj.frames.to_geotiff(tmp_path / f"t{frame}.tif", frame=frame)
        jproj.frames.to_geotiff(tmp_path / f"j{frame}.tif", frame=frame)
        assert (tmp_path / f"t{frame}.tif").read_bytes() == (tmp_path / f"j{frame}.tif").read_bytes()
    with pytest.raises(ValueError, match="projected"):
        scene["frames"]["pyorc_tpu_torch"].frames.to_geotiff(tmp_path / "raw.tif")
    with pytest.raises(AssertionError, match="projected"):
        scene["frames"]["pyorc_tpu"].frames.to_geotiff(tmp_path / "raw.tif")


def test_to_geotiffs_lazy_reads_each_frame_once(scene, tmp_path):
    """``to_geotiffs`` of a lazy projected chain writes JAX's files (in-memory frames) and
    decodes and uploads each selected frame once."""
    source, da = _lazy(scene["stack"], scene["cc"])
    lazy_proj = da.frames.project()
    _device.COPY_BYTES.update(h2d=0, d2h=0)
    got = lazy_proj.frames.to_geotiffs(str(tmp_path / "t"), start_frame=1, stride=2, progress_bar=False)
    want = scene["proj"]["pyorc_tpu"].frames.to_geotiffs(str(tmp_path / "j"), start_frame=1, stride=2,
                                                          progress_bar=False)
    assert [os.path.basename(f) for f in got] == ["t_0001.tif", "t_0003.tif", "t_0005.tif"]
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert sorted(source.decoded) == [1, 3, 5]
    r0, r1, c0, c1 = lazy_proj.data._crop
    out_h, out_w = lazy_proj.shape[1:]
    assert _device.COPY_BYTES["h2d"] == 3 * (r1 - r0) * (c1 - c0)
    assert _device.COPY_BYTES["d2h"] == 3 * out_h * out_w


def test_project_numpy_equals_jax(scene):
    """``project_numpy`` / ``project_cv`` (the same index maps) give JAX's frames and coords."""
    cc = scene["cc"]
    jcc = pyorc_tpu.api.cameraconfig.get_camera_config(cc.to_json())
    tproj = scene["proj"]["pyorc_tpu_torch"]
    x, y = tproj["x"].values, tproj["y"].values
    for name, reducer in (("project_numpy", "mean"), ("project_cv", None)):
        got = getattr(pyorc_tpu_torch, name)(scene["frames"]["pyorc_tpu_torch"], cc, x, y, 0.0, reducer=reducer)
        want = getattr(pyorc_tpu, name)(scene["frames"]["pyorc_tpu"], jcc, x, y, 0.0, reducer=reducer)
        np.testing.assert_array_equal(got.values, np.asarray(want.values))
        assert got.dims == want.dims and set(got.coords) == set(want.coords)
        frame = getattr(pyorc_tpu_torch, name)(scene["stack"][0], cc, x, y, 0.0, reducer=reducer)
        np.testing.assert_array_equal(frame, got.values[0])


def test_parse_geotiff_equals_jax(scene, tmp_path):
    """``parse_geotiff`` projects the clip's RGB sample frame (nearest) into JAX's file, and
    logs and returns on error, as JAX's does."""
    clip = chip_smoke.write_clip(scene["stack"], tmp_path / "clip.avi")
    fn_cc = tmp_path / "cc.json"
    scene["cc"].to_file(str(fn_cc))
    log = logging.getLogger("test_parse_geotiff")
    tcli.parse_geotiff(str(clip), str(fn_cc), str(tmp_path / "t.tif"), frame_sample=2, logger=log)
    jcli.parse_geotiff(str(clip), str(fn_cc), str(tmp_path / "j.tif"), frame_sample=2, logger=log)
    assert (tmp_path / "t.tif").read_bytes() == (tmp_path / "j.tif").read_bytes()
    assert (tmp_path / "t.tif").stat().st_size > 3 * 64 * 96

    class _Log(logging.Logger):
        def __init__(self):
            super().__init__("errors")
            self.errors = []

        def error(self, msg, *args, **kwargs):
            self.errors.append(msg)

    for mod in (tcli, jcli):
        errors = _Log()
        mod.parse_geotiff(str(tmp_path / "missing.avi"), str(fn_cc), str(tmp_path / "m.tif"), logger=errors)
        assert len(errors.errors) == 1 and "Could not create sample geotiff" in errors.errors[0]
    assert not (tmp_path / "m.tif").exists()


# -- video ---------------------------------------------------------------------


class _Recorder:
    """Stands in for ``NativeVideoWriter``: keeps every frame written."""

    made = []

    def __init__(self, path, width, height, fps=25.0, channels=1, crf=18):
        self.path, self.shape, self.fps = path, (height, width) if channels == 1 else (height, width, 3), fps
        self.frames = []
        _Recorder.made.append(self)

    def write(self, frame):
        assert frame.dtype == np.uint8 and frame.shape == self.shape, (frame.dtype, frame.shape)
        self.frames.append(np.array(frame))

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@pytest.fixture
def recorded(monkeypatch):
    """Swap both packages' native writer for :class:`_Recorder`; returns ``frames(da, **kw)``,
    the uint8 frames ``da.frames.to_video`` hands its writer."""
    monkeypatch.setattr(jnative, "NativeVideoWriter", _Recorder)
    monkeypatch.setattr(tnative, "NativeVideoWriter", _Recorder)
    monkeypatch.setattr(tnative, "encoder_available", lambda: True)

    def frames(da, **kwargs):
        _Recorder.made.clear()
        da.frames.to_video("unused.mp4", progress=False, **kwargs)
        (writer,) = _Recorder.made
        return np.stack(writer.frames), writer.fps

    return frames


def _edge_stack(rgb=False):
    """Float32 frames [6, 24, 32] (or RGB) holding every edge of the uint8 cast."""
    rng = np.random.default_rng(5)
    shape = (6, 24, 32, 3) if rgb else (6, 24, 32)
    stack = rng.normal(0.0, 40.0, size=shape).astype(np.float32)
    stack[0, 3:7, 5:9] = np.nan  # NaN pixels in a frame that is rescaled
    stack[1] = np.nan  # all NaN: nanmin is NaN, no rescale
    stack[2] = -5.0  # constant: no rescale, cast as it is
    stack[3, 0, :4] = np.reshape((300.0, 1e10, -1e10, np.inf), (4,) + (1,) * rgb)  # out of range (rescaled for gray)
    stack[4] = np.linspace(-700.0, 700.0, stack[4].size).reshape(stack[4].shape)
    return stack


def _dataarray(pkg, stack, fps=5.0):
    dims = ("time", "y", "x", "rgb") if stack.ndim == 4 else ("time", "y", "x")
    coords = {"time": np.arange(len(stack)) / fps, "y": np.arange(stack.shape[1])[::-1] * 1.0,
              "x": np.arange(stack.shape[2]) * 1.0}
    return pkg.ndx.DataArray(stack, dims=dims, coords=coords, name="frames")


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgb_uint8"])
def test_to_video_frames_equal_jax(recorded, kind):
    """In memory: the uint8 frames of ``to_video`` are JAX's, byte for byte, for every edge of
    the cast, and the frame rate is JAX's."""
    stack = _edge_stack(rgb=kind != "gray")
    if kind == "rgb_uint8":
        stack = np.nan_to_num(stack).clip(0, 255).astype(np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # JAX's nanmin of the all-NaN frame, numpy's cast
        want, fps_want = recorded(_dataarray(pyorc_tpu, stack))
    got, fps_got = recorded(_dataarray(pyorc_tpu_torch, stack))
    np.testing.assert_array_equal(got, want)
    assert fps_got == fps_want == 5.0
    if kind == "gray":
        assert (got[1] == 0).all() and (got[2] == 251).all()  # all-NaN frame; -5.0 wraps
        assert got[0].min() == 0 and got[0].max() == 255


def test_video_uint8_rule_on_the_cpu():
    """:func:`video_uint8` is numpy's cast of JAX's rescaled float32 frames, frame by frame."""
    stack = _edge_stack()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = []
        for f in stack:
            fmin, fmax = np.nanmin(f), np.nanmax(f)
            want.append(((f - fmin) / (fmax - fmin) * 255 if fmax > fmin else f).astype(np.uint8))
    np.testing.assert_array_equal(tflt.video_uint8(torch.from_numpy(stack)).numpy(), np.stack(want))


def test_to_video_lazy_decodes_once_and_downloads_uint8(scene, recorded):
    """A lazy projected chain: JAX's frames (in memory), each frame decoded and uploaded
    once, and only uint8 frames (1 B a projected pixel) downloaded."""
    source, da = _lazy(scene["stack"], scene["cc"])
    lazy_proj = da.frames.minmax(min=10).frames.project()
    jproj = scene["frames"]["pyorc_tpu"].frames.minmax(min=10).frames.project()
    want, _ = recorded(jproj)
    _device.COPY_BYTES.update(h2d=0, d2h=0)
    got, _ = recorded(lazy_proj)
    np.testing.assert_array_equal(got, want)
    assert sorted(source.decoded) == list(range(N))
    r0, r1, c0, c1 = lazy_proj.data._crop
    assert _device.COPY_BYTES["h2d"] == N * (r1 - r0) * (c1 - c0)
    assert _device.COPY_BYTES["d2h"] == got.size == N * lazy_proj.shape[1] * lazy_proj.shape[2]


def test_to_video_cv2_writer_ffv1(monkeypatch, recorded, tmp_path, caplog):
    """Without the native encoder the port writes with ``cv2.VideoWriter`` and ``video_format``
    as its fourcc, and says so in its log; FFV1 decodes back to the recorded frames."""
    import cv2

    for kind, stack in (("gray", _edge_stack()), ("rgb", _edge_stack(rgb=True))):
        want, _ = recorded(_dataarray(pyorc_tpu_torch, stack))
        monkeypatch.setattr(tnative, "encoder_available", lambda: False)
        fn = tmp_path / f"{kind}.avi"
        with caplog.at_level(logging.INFO, logger="pyorc_tpu_torch.api.frames"):
            _dataarray(pyorc_tpu_torch, stack).frames.to_video(fn, video_format="FFV1", progress=False)
        assert "cv2.VideoWriter, fourcc 'FFV1'" in caplog.text
        cap = cv2.VideoCapture(str(fn))
        got = []
        while True:
            ok, img = cap.read()
            if not ok:
                break
            got.append(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if kind == "gray" else img[..., ::-1])
        cap.release()
        np.testing.assert_array_equal(np.stack(got), want)
        monkeypatch.setattr(tnative, "encoder_available", lambda: True)


def test_to_ani_frames_equal_jax(scene, monkeypatch):
    """``to_ani`` (cv2 route, ffmpeg absent): the rendered frames handed to cv2's writer are
    JAX's; the lazy stack is decoded once, in order."""
    import cv2
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation

    class _CvRecorder:
        made = []

        def __init__(self, fn, fourcc, fps, size):
            self.frames = []
            _CvRecorder.made.append(self)

        def write(self, frame):
            self.frames.append(np.array(frame))

        def release(self):
            pass

    monkeypatch.setattr(animation.writers, "is_available", lambda name: False)
    monkeypatch.setattr(cv2, "VideoWriter", _CvRecorder)
    kwargs = dict(figure_kwargs={"figsize": (2.0, 1.5), "dpi": 40, "frameon": False},
                  video_kwargs={"fps": 5}, progress_bar=False, cmap="gray", vmin=0, vmax=255)
    source, da = _lazy(scene["stack"], scene["cc"])
    out = []
    for frames in (scene["proj"]["pyorc_tpu"], da.frames.project()):
        _CvRecorder.made.clear()
        frames.frames.to_ani("unused.mp4", **kwargs)
        (writer,) = _CvRecorder.made
        out.append(np.stack(writer.frames))
    assert out[0].shape[0] == N
    np.testing.assert_array_equal(out[1], out[0])
    assert source.decoded == list(range(N))


# -- sample data -----------------------------------------------------------------


def test_sample_data_cache_and_hash(monkeypatch, tmp_path):
    """``sample_data``: the cache path and the checksum check of JAX's, urllib patched (no network)."""
    import hashlib
    import io
    import urllib.request

    from pyorc_tpu import sample_data as jsd

    from pyorc_tpu_torch import sample_data as tsd

    body = b"sample bytes"
    urls = []

    class _Response(io.BytesIO):
        def info(self):
            return {}

    def fake_urlopen(url, *args, **kwargs):
        urls.append(getattr(url, "full_url", url))
        return _Response(body)

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    for mod in (tsd, jsd):
        monkeypatch.setenv("PYORC_TPU_CACHE", str(tmp_path / mod.__name__))
        assert mod.cache_path() == tmp_path / mod.__name__
        path = mod._fetch("cs1.geojson", hashlib.sha256(body).hexdigest())
        assert path == str(tmp_path / mod.__name__ / "cs1.geojson") and open(path, "rb").read() == body
        assert mod._fetch("cs1.geojson") == path  # cached: no second download
        with pytest.raises(IOError, match="Checksum mismatch"):
            mod._fetch("cam_config_gcps.json", "0" * 64)
        assert not (tmp_path / mod.__name__ / "cam_config_gcps.json").exists()
        assert mod.get_hommerich_pyorc_zip().endswith("hommerich_20241010_081717_pyorc_data.zip.zip")
    assert urls[:3] == urls[3:] and len(urls) == 6
    assert urls[0] == f"{tsd.BASE_URL}/cs1.geojson" and urls[2].startswith("https://zenodo.org/records/15002591/")
    monkeypatch.delenv("PYORC_TPU_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert tsd.cache_path() == jsd.cache_path() == tmp_path / "home" / ".cache" / "pyorc_tpu"
