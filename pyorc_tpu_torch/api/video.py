"""Video: host decode + lazy frame access feeding the device pipeline.

Port of :mod:`pyorc_tpu.api.video` (reference ``pyorc/api/video.py``):
validates metadata, scans timestamps, applies rotation/stabilization/color
conversion, and produces a ``frames`` DataArray backed by :class:`LazyFrames`
— a deferred decoder whose op chain (filters, projection) runs per batch on
the device, streaming into ``Frames.get_piv``.

Decode back ends, in order: the native FFmpeg pump
(:mod:`pyorc_tpu_torch.io.native_decoder`, built from ``native/decoder.cpp``;
``PYORC_TPU_NATIVE_DECODE=0`` turns it off, ``PYORC_TPU_DECODE_WORKERS`` sets
its GOP-parallel workers), then OpenCV. Reading a file's metadata needs
OpenCV, as in the JAX package; cv2 is imported when a ``Video`` is made, not
with the package.
"""

from __future__ import annotations

import copy
import json
import os
import warnings
from typing import List, Optional, Union

import numpy as np
import torch

from .. import const, ndx
from .._device import PinnedUploader, get_device, to_device, to_host
from ..io import video_reader as vr
from .cameraconfig import CameraConfig, get_camera_config, load_camera_config

__all__ = ["Video", "LazyFrames"]


def _cv2():
    """OpenCV, or an ImportError that says what reading a video needs and what is missing."""
    try:
        import cv2
    except ImportError as err:
        from ..io import native_decoder

        native = "available" if native_decoder.available() else f"unavailable too ({native_decoder.load_error()})"
        raise ImportError(
            "pyorc_tpu_torch.Video needs OpenCV (cv2) to read a video's metadata and to decode what the "
            "native FFmpeg decoder does not (rotation, stabilization, hsv), and cv2 is not installed; the "
            f"native decoder built from native/decoder.cpp is {native}. Frame stacks already in memory "
            "go through ndx.DataArray(...).frames without either."
        ) from err
    return cv2


def _native_on() -> bool:
    return os.environ.get("PYORC_TPU_NATIVE_DECODE", "1") != "0"


def _decode_workers() -> Optional[int]:
    """``PYORC_TPU_DECODE_WORKERS``: a count of GOP-parallel native decoders, or None for "auto" (the default)."""
    value = os.environ.get("PYORC_TPU_DECODE_WORKERS", "auto")
    return None if value == "auto" else int(value)


class LazyFrames:
    """Array-like of video frames, decoded on demand in batches.

    Supports time-axis slicing without decoding; any full materialization
    (``np.asarray``) decodes everything. ``iter_batches`` streams overlapping
    batches for the PIV loop.

    Each batch is decoded on the host (``video._decode_frames(positions,
    method)``); when the view has ops, it is then cropped to ``crop`` (rows
    r0:r1, columns c0:c1; set by ``Frames.project``), uploaded once, and the
    ops (filters, projection) run on the device one after the other, handing
    device tensors to each other and to the consumer. Data come back to the
    host only through ``np.asarray`` / ``.values`` / ``__getitem__`` with an
    integer. A view without ops yields the decoded host batches.
    """

    def __init__(self, video, method: str, indices: np.ndarray, frame_shape, dtype=np.uint8, ops=None, crop=None):
        self._video = video
        self._method = method
        self._indices = np.asarray(indices)  # positions into video.frame_number
        self._frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self._ops = list(ops) if ops else []
        self._crop = crop

    def _view(self, indices=None, **changes) -> "LazyFrames":
        kwargs = dict(
            frame_shape=self._frame_shape, dtype=self.dtype, ops=self._ops, crop=self._crop,
        )
        kwargs.update({k: v for k, v in changes.items() if v is not None})
        return LazyFrames(self._video, self._method, self._indices if indices is None else indices, **kwargs)

    def with_op(self, fn, frame_shape=None, dtype=None) -> "LazyFrames":
        """A new view applying ``fn`` (device batch -> device batch) on read."""
        return self._view(frame_shape=frame_shape, dtype=dtype, ops=self._ops + [fn])

    def with_chain(self, ops, frame_shape=None, dtype=None, crop=None) -> "LazyFrames":
        """A new view with the op chain REPLACED by ``ops`` and the upload crop by ``crop`` (same decode)."""
        view = self._view(frame_shape=frame_shape, dtype=dtype)
        view._ops, view._crop = list(ops), crop
        return view

    @property
    def shape(self):
        return (len(self._indices),) + self._frame_shape

    @property
    def ndim(self):
        return 1 + len(self._frame_shape)

    def __len__(self):
        return len(self._indices)

    def read_batch(self, i0: int, i1: int, uploader: Optional[PinnedUploader] = None):
        """Frames [i0:i1] (positions within this view): a device tensor when the view has ops."""
        with torch.profiler.record_function("lazy:decode"):
            out = self._video._decode_frames(self._indices[i0:i1], self._method)
        if not self._ops:
            return out
        if self._crop is not None:
            r0, r1, c0, c1 = self._crop
            out = out[:, r0:r1, c0:c1]
        with torch.profiler.record_function("lazy:upload"):
            out = uploader.upload(out) if uploader is not None else to_device(out)
        for fn in self._ops:
            out = fn(out)
        return out

    def iter_batches(self, batch_size: int, overlap: int = 0, prefetch: int = 2):
        """Yield (start, batch) with ``overlap`` trailing frames repeated between batches.

        A worker thread decodes, uploads (on the card through pinned buffers on
        a side stream) and runs the op chain ``prefetch`` batches ahead. The
        repeated frames are not decoded or uploaded again: every op of the
        chain maps each frame on its own, so the previous batch's last
        ``overlap`` output frames are reused.
        """
        n = len(self)
        ranges = []
        start = 0
        while start < n - overlap or (start == 0 and n > 0):
            end = min(start + batch_size, n)
            ranges.append((start, end))
            if end >= n:
                break
            start = end - overlap
        uploader = None
        if self._ops and get_device().type == "cuda":
            uploader = PinnedUploader(get_device())
        tail = None  # the previous batch's last `overlap` frames; the worker thread alone touches it

        def batch(a, b):
            nonlocal tail
            reused = 0 if tail is None else tail.shape[0]
            out = self.read_batch(a + reused, b, uploader)
            if reused:
                out = torch.cat([tail, out]) if torch.is_tensor(out) else np.concatenate([tail, out])
            tail = out[out.shape[0] - overlap :] if overlap else None
            return a, out

        yield from vr.BatchPrefetcher(batch, ranges, depth=prefetch)

    def __array__(self, dtype=None, copy=None):
        out = np.empty(self.shape, dtype=self.dtype)
        for start, batch in self.iter_batches(64):
            out[start : start + batch.shape[0]] = to_host(batch)
        return out.astype(dtype) if dtype is not None else out

    def __getitem__(self, key):
        if isinstance(key, tuple):
            tkey, rest = key[0], key[1:]
        else:
            tkey, rest = key, ()
        if np.ndim(tkey) == 0 and not isinstance(tkey, slice):
            frame = to_host(self.read_batch(int(tkey), int(tkey) + 1))[0]
            return frame[rest] if rest else frame
        sub = self._view(indices=self._indices[tkey] if isinstance(tkey, slice) else self._indices[np.asarray(tkey)])
        if rest and any(k != slice(None) for k in rest):
            return np.asarray(sub)[(slice(None),) + rest]
        return sub

    def astype(self, dtype):
        return np.asarray(self).astype(dtype)

    def copy(self):
        return self._view(indices=self._indices.copy())

    def __repr__(self):
        return f"<LazyFrames {self.shape} {self.dtype} of {self._video.fn}>"


class Video:
    """A video file with camera configuration, frame range and water level."""

    def __init__(
        self,
        fn: str,
        camera_config: Optional[Union[str, dict, CameraConfig]] = None,
        h_a: Optional[float] = None,
        start_frame: Optional[int] = None,
        end_frame: Optional[int] = None,
        freq: int = 1,
        chunksize: int = 20,
        stabilize: Optional[List[List]] = None,
        lazy: bool = True,
        rotation: Optional[int] = None,
        fps: Optional[float] = None,
        progress: bool = True,
    ):
        cv2 = _cv2()
        if not isinstance(start_frame, (int, type(None))):
            raise TypeError('start_frame must be of type "int"')
        if not isinstance(end_frame, (int, type(None))):
            raise TypeError('end_frame must be of type "int"')
        self.ms = None
        self.mask = None
        self.lazy = lazy
        self.progress = progress
        self.stabilize = stabilize
        if camera_config is not None:
            self.camera_config = camera_config
            if h_a is not None:
                for key in ("z_0", "h_ref"):
                    if not isinstance(self.camera_config.gcps.get(key), float):
                        raise ValueError(f"h_a was supplied, but camera config's gcps do not contain {key}.")
                if np.abs(h_a - self.camera_config.gcps["h_ref"]) > const.WATER_LEVEL_MAX_DIFF:
                    warnings.warn(
                        f"h_a is more than {const.WATER_LEVEL_MAX_DIFF} meters different from h_ref. "
                        "Check if your h_a uses the same datum as h_ref.",
                        stacklevel=2,
                    )
        if not os.path.isfile(fn):
            raise IOError(f"Video file {fn} does not exist.")

        cap = cv2.VideoCapture(fn)
        try:
            cap.set(cv2.CAP_PROP_ORIENTATION_AUTO, 1)
            self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            if self.stabilize is not None:
                self.set_mask_from_exterior(self.stabilize)
            frame_count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) - 1
            if frame_count <= 0:
                if lazy:
                    raise IOError(
                        f"Video file {fn} has no proper metadata; cannot read with `lazy=True`. "
                        f"Re-attempt reading this video with `lazy=False`."
                    )
                warnings.warn(f"Video file {fn} has no proper metadata; attempting best-effort read.", stacklevel=2)
                frame_count = 3600 * 60
            self.frame_count = frame_count
            if start_frame is not None:
                if start_frame > self.frame_count > 0:
                    raise ValueError("Start frame is larger than total amount of frames")
            else:
                start_frame = 0
            if end_frame is not None:
                if end_frame < start_frame:
                    raise ValueError(f"Start frame {start_frame} is larger than end frame {end_frame}")
                end_frame = int(np.minimum(end_frame, self.frame_count))
            else:
                end_frame = self.frame_count
            self.rotation = rotation
            time = frame_number = None
            if lazy:
                time, frame_number = self._native_time_scan(fn, start_frame, end_frame, fps)
            frames = None
            if time is None:
                time, frame_number, frames = vr.get_time_frames(
                    cap,
                    start_frame,
                    end_frame,
                    lazy=lazy,
                    rotation=self._rotation_code,
                    method="bgr",
                    fps=fps,
                    progress=progress,
                )
            self._eager_frames = frames
            if len(frame_number) > 0 and frame_number[-1] != end_frame:
                warnings.warn(
                    f"End frame {end_frame} cannot be read from file. End frame is adapted to {frame_number[-1]}",
                    stacklevel=2,
                )
                end_frame = frame_number[-1]
            self.end_frame = end_frame
            self.freq = freq
            self.chunksize = chunksize
            self.time = time
            self.frame_number = frame_number
            self.start_frame = start_frame
            if self.stabilize is not None:
                self.get_ms(cap)
            self.fps = fps if fps is not None else cap.get(cv2.CAP_PROP_FPS)
            self.h_a = h_a
            self.fn = fn
        finally:
            cap.release()

    def __getstate__(self):
        # the native decoder handle (ctypes) is not picklable/deep-copyable;
        # it is re-opened lazily after restore
        d = self.__dict__.copy()
        d.pop("_native_reader_cache", None)
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)

    # -- properties ------------------------------------------------------------

    @property
    def camera_config(self):
        return getattr(self, "_camera_config", None)

    @camera_config.setter
    def camera_config(self, camera_config_input):
        try:
            if isinstance(camera_config_input, str):
                if os.path.isfile(camera_config_input):
                    self._camera_config = load_camera_config(camera_config_input)
                else:
                    self._camera_config = get_camera_config(camera_config_input)
            elif isinstance(camera_config_input, CameraConfig):
                self._camera_config = camera_config_input
            elif isinstance(camera_config_input, dict):
                self._camera_config = CameraConfig(**camera_config_input)
        except IOError:
            raise IOError("Could not recognise input as a CameraConfig file, string, dictionary or object.")

    @property
    def h_a(self):
        return self._h_a

    @h_a.setter
    def h_a(self, h_a):
        if h_a is not None:
            if not isinstance(h_a, float):
                raise TypeError(f"The actual water level must be a float, got {type(h_a)}")
            if h_a < 0:
                warnings.warn("Water level is negative. This may be unlikely with a staff gauge.", stacklevel=2)
        self._h_a = h_a

    @property
    def fps(self):
        return self._fps

    @fps.setter
    def fps(self, fps):
        if np.isinf(fps) or fps <= 0:
            raise ValueError(f"FPS in video is {fps} which is not valid. Repair the video file before use.")
        self._fps = float(fps)

    @property
    def rotation(self):
        if self._rotation_code is not None:
            return self._rotation_code
        if self.camera_config is not None and getattr(self.camera_config, "rotation", None) is not None:
            return vr.get_rotation_code(self.camera_config.rotation)
        return None

    @rotation.setter
    def rotation(self, rotation):
        self._rotation_code = vr.get_rotation_code(rotation)

    @property
    def stabilize(self):
        if self._stabilize is not None:
            return self._stabilize
        if self.camera_config is not None:
            return getattr(self.camera_config, "stabilize", None)
        return None

    @stabilize.setter
    def stabilize(self, coords):
        self._stabilize = coords

    @property
    def lazy(self):
        """Lazy (deferred-decode) flag."""
        return self._lazy

    @lazy.setter
    def lazy(self, lazy):
        self._lazy = lazy

    @property
    def freq(self):
        """Frame sampling frequency (every freq-th frame)."""
        return self._freq

    @freq.setter
    def freq(self, freq=1):
        self._freq = freq

    @property
    def progress(self):
        """Progress-bar flag."""
        return self._progress

    @progress.setter
    def progress(self, progress=True):
        self._progress = progress

    @property
    def mask(self):
        """Region mask for stabilization (255 outside the water polygon)."""
        return self._mask

    @mask.setter
    def mask(self, mask):
        self._mask = mask

    @property
    def corners(self):
        """[column, row] image locations of the area of interest (4 corners)."""
        return getattr(self, "_corners", None)

    @corners.setter
    def corners(self, corners):
        self._corners = corners

    @property
    def frames(self):
        """Eagerly-read frames (``lazy=False``), else None."""
        return self._eager_frames

    @property
    def end_frame(self):
        return self._end_frame

    @end_frame.setter
    def end_frame(self, end_frame=None):
        self._end_frame = self.frame_count - 1 if end_frame is None else end_frame

    @property
    def start_frame(self):
        return self._start_frame

    @start_frame.setter
    def start_frame(self, start_frame=None):
        self._start_frame = 0 if start_frame is None else start_frame

    # -- decode ------------------------------------------------------------

    def _native_time_scan(self, fn, start_frame, end_frame, fps):
        """Timestamp scan via the native pts index (one packet scan, no
        decoding) instead of decoding every frame like the cv2 scan
        (reference pyorc/cv.py:923-990). Returns (None, None) when the
        native decoder is unavailable so the caller falls back to cv2.
        """
        if not _native_on():
            return None, None
        from ..io import native_decoder

        if not native_decoder.available():
            return None, None
        try:
            reader = native_decoder.NativeVideoReader(fn)
        except (RuntimeError, OSError):
            return None, None
        ts = reader.timestamps()
        if ts is None or len(ts) == 0:
            reader.close()
            return None, None
        end = int(min(end_frame, len(ts) - 1))
        # tail validation: the index counts packets; confirm the last frame
        # actually decodes, walking back over a corrupt tail
        while end >= start_frame and reader.read(end, 1, gray=True).shape[0] == 0:
            end -= 1
        if end < start_frame:
            reader.close()
            return None, None
        if "PYORC_TPU_DECODE_WORKERS" in os.environ and (_decode_workers() or 2) > 1:
            reader.close()  # the _native_reader property builds the parallel pump (or decides, for "auto")
        else:
            self._native_reader_cache = reader
        frame_number = list(range(start_frame, end + 1))
        if fps is not None:
            time = [n * 1000.0 / fps for n in frame_number]
        else:
            time = [float(ts[n]) for n in frame_number]
        return time, frame_number

    @property
    def _native_reader(self):
        """Cached native decode pump (FFmpeg libav via ctypes), or None.

        Used as the batch-decode fast path when no per-frame cv2 processing
        (rotation / stabilization warps) is needed. Disable with
        PYORC_TPU_NATIVE_DECODE=0. The native path produces the same pixels
        as cv2's FFMPEG backend: swscale BGR24 + cv2's fixed-point gray
        weights (see native/decoder.cpp).
        """
        if getattr(self, "_native_reader_cache", "unset") == "unset":
            self._native_reader_cache = None
            if _native_on():
                from ..io import native_decoder

                if native_decoder.available():
                    workers = _decode_workers()
                    if workers is None:
                        # GOP-parallel decode pays off for long high-res
                        # sources; short/small clips keep one decoder
                        big = (self.height or 0) >= 1080 and len(self.frame_number) >= 64
                        workers = min(6, os.cpu_count() or 1) if big else 1
                    try:
                        if workers > 1:
                            self._native_reader_cache = native_decoder.ParallelVideoReader(self.fn, workers=workers)
                        else:
                            self._native_reader_cache = native_decoder.NativeVideoReader(self.fn)
                    except (RuntimeError, OSError):
                        self._native_reader_cache = None
        return self._native_reader_cache

    def _decode_frames_native(self, positions: np.ndarray, method: str) -> Optional[np.ndarray]:
        """Batch-decode via the native pump; None if this request needs cv2."""
        if method not in ("grayscale", "rgb", "bgr") or self.rotation is not None or self.ms is not None:
            return None
        reader = self._native_reader
        if reader is None or len(positions) == 0:
            return None
        fnos = np.asarray(self.frame_number)[positions]
        lo, hi = int(fnos.min()), int(fnos.max())
        span = hi - lo + 1
        # decode the contiguous span once (the codec must decode every frame
        # anyway) and subsample; bail out if the span would blow up memory
        ch = 1 if method == "grayscale" else 3
        if span * reader.height * reader.width * ch > 2 << 30:
            return None
        batch = reader.read(lo, span, gray=(method == "grayscale"))
        if batch.shape[0] < span:
            return None  # unreadable tail: let the cv2 path raise precisely
        out = batch[fnos - lo]
        if method == "bgr":
            out = out[..., ::-1]
        return np.ascontiguousarray(out)

    def _decode_frames(self, positions: np.ndarray, method: str) -> np.ndarray:
        """Decode frames at the given positions (indices into frame_number)."""
        positions = np.atleast_1d(positions)
        if self._eager_frames is not None:
            imgs = []
            for p in positions:
                img = self._eager_frames[p]
                if self.ms is not None:
                    img = vr.warp_affine(img, self.ms[p])
                imgs.append(vr.color_scale(img, method))
            return np.asarray(imgs)
        native = self._decode_frames_native(positions, method)
        if native is not None:
            return native
        cv2 = _cv2()
        cap = cv2.VideoCapture(self.fn)
        imgs = []
        prev = None
        try:
            for p in positions:
                fno = self.frame_number[p]
                if prev is None or fno != prev + 1:
                    cap.set(cv2.CAP_PROP_POS_FRAMES, np.float64(fno))
                ret, img = vr.get_frame(
                    cap,
                    rotation=self.rotation,
                    ms=self.ms[p] if self.ms is not None else None,
                    method=method,
                )
                if not ret:
                    raise IOError(f"Cannot read frame {fno} from {self.fn}")
                imgs.append(img)
                prev = fno
        finally:
            cap.release()
        return np.asarray(imgs)

    def get_frame(self, n: int, method: str = "grayscale") -> np.ndarray:
        if n < 0:
            raise ValueError("frame number cannot be negative")
        if n - self.start_frame > self.end_frame - self.start_frame:
            raise ValueError("frame number exceeds the start/end frame range")
        return self._decode_frames(np.array([n]), method)[0]

    def get_frames_chunk(self, n_start: int, n_end: int, method: str = "grayscale") -> np.ndarray:
        return self._decode_frames(np.arange(n_start, n_end), method)

    def get_frames(self, method: str = "grayscale") -> ndx.DataArray:
        """Frames as a (lazily decoded) ndx.DataArray with full metadata."""
        if self.camera_config is None:
            raise ValueError("No camera configuration is set, add it to the video using the .camera_config property")
        camera_config = copy.deepcopy(self.camera_config)
        sample = self._decode_frames(np.array([0]), method)[0]
        lazy = LazyFrames(self, method, np.arange(len(self.frame_number)), sample.shape, dtype=sample.dtype)
        time = np.array(self.time) * 0.001
        y = np.flipud(np.arange(sample.shape[0])).astype(np.float64)
        x = np.arange(sample.shape[1]).astype(np.float64)
        xp, yp = np.meshgrid(x, y)
        coords = {"time": time, "y": y, "x": x}
        dims = ["time", "y", "x"]
        if sample.ndim == 3:
            coords["rgb"] = np.array([0, 1, 2])
            dims.append("rgb")
        attrs = {
            "camera_shape": str([len(y), len(x)]),
            "camera_config": camera_config.to_json(),
            "h_a": json.dumps(self.h_a),
            "chunksize": self.chunksize,
        }
        data = lazy if self.freq == 1 else lazy[:: self.freq]
        if self.freq != 1:
            coords["time"] = time[:: self.freq]
        frames = ndx.DataArray(data, dims=tuple(dims), coords=coords, attrs=attrs, name="frames")
        frames = frames.frames.add_xy_coords({"xp": xp, "yp": yp}, coords, const.PERSPECTIVE_ATTRS)
        frames.name = "frames"
        return frames

    # -- stabilization ------------------------------------------------------------

    def set_mask_from_exterior(self, exterior):
        """Mask: 255 outside the water polygon (used for stabilization points)."""
        cv2 = _cv2()
        mask_coords = np.array([exterior], dtype=np.int32)
        mask = np.zeros((self.height, self.width), np.uint8)
        mask = cv2.fillPoly(mask, [mask_coords], 255)
        mask[mask == 0] = 1
        mask[mask == 255] = 0
        mask[mask == 1] = 255
        self.mask = mask

    def get_ms(self, cap=None, split: int = 2):
        """Derive per-frame stabilization affines (GFTT + LK flow + smoothing)."""
        from ..io.stabilize import get_ms_gftt

        release = cap is None
        if release:
            cap = _cv2().VideoCapture(self.fn)
        try:
            self.ms = get_ms_gftt(
                cap,
                start_frame=self.start_frame,
                end_frame=self.end_frame,
                split=split,
                mask=self.mask,
                progress=self.progress,
            )
        finally:
            if release:
                cap.release()
