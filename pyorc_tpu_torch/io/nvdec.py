"""H.264 decode on the card: the NVDEC reader, the libavcodec-to-YUV reader, and the YUV conversion kernel.

The card's counterpart of the native pump's contract
(:class:`pyorc_tpu_torch.io.native_decoder.NativeVideoReader`): ``read(start,
count, gray)`` gives frames in presentation order, seeks through the demuxer's
index (:mod:`pyorc_tpu_torch.io.mp4`), ``timestamps()`` comes from the
container, and the pixels are the pump's (and OpenCV's) bit for bit, but the
frames are a uint8 tensor on the card: [count, H, W] gray or [count, H, W, 3]
RGB.

- :class:`LibavVideoReader` decodes with libavcodec on the host to YUV
  (:mod:`pyorc_tpu_torch.io.libav`), uploads the 4:2:0 planes and converts
  them on the card: the route ``Video``'s plan takes on a card.
- :class:`NvdecVideoReader` decodes on the card's NVDEC engines
  (``csrc/nvdec.cu``, through ``libnvcuvid.so.1``); each picture is converted
  where the decoder leaves it. Not yet verified on a card (the card reached
  so far refuses every cuvid call), so the plan does not take it;
  ``chip_smoke.py`` holds its frames to OpenCV's wherever NVDEC answers.

:func:`yuv420_to_frames` is the conversion: one launch of the hand-written
kernel ``csrc/nv12.cu`` on a CUDA tensor (counted in
``piv_kernels.LAUNCHES["yuv420_to_frames"]``), its plain version
:func:`yuv420_to_frames_plain` on a CPU tensor. :func:`plan` says whether a
file and a device take NVDEC, and if not, why; :func:`decoder_caps` is the
probe behind it.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _device
from ..ops import piv_kernels
from . import mp4

__all__ = [
    "yuv420_to_frames",
    "yuv420_to_frames_plain",
    "decoder_caps",
    "plan",
    "track_for",
    "NvdecVideoReader",
    "LibavVideoReader",
    "KERNEL",
    "PATHS",
]

KERNEL = "yuv420_to_frames"  # its key in piv_kernels.LAUNCHES and KERNEL_ROUTE
# the conversion kernel's launches through yuv420_to_frames by the access path csrc/nv12.cu took
# (yuv420_convert_path): whole 16-byte vectors, or bytes for any other layout
PATHS = {"16-byte": 0, "scalar": 0}

# swscale's yuv2rgb in 16-bit fixed point (BT.601, limited range) and OpenCV 4's 15-bit BGR2GRAY weights: csrc/nv12.cu
_Y_COEFF, _Y_OFFSET, _UB, _UG, _VG, _VR = 9539, 128, 16525, -3209, -6660, 13075
_GRAY_B, _GRAY_G, _GRAY_R = 3735, 19235, 9798


def yuv420_to_frames_plain(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, gray: bool) -> torch.Tensor:
    """The conversion in int32 tensor ops: ``y`` [n, H, W], ``u`` and ``v`` [n, H/2, W/2] (uint8)
    -> [n, H, W] gray or [n, H, W, 3] RGB uint8, the arithmetic of ``csrc/nv12.cu``."""
    yy = (((y.to(torch.int32) << 3) - _Y_OFFSET) * _Y_COEFF) >> 16
    uc = (u.to(torch.int32) << 3) - 1024
    vc = (v.to(torch.int32) << 3) - 1024

    def up(c):  # each chroma sample serves its 2x2 block
        return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    ub, vr = up((uc * _UB) >> 16), up((vc * _VR) >> 16)
    uvg = up(((uc * _UG) >> 16) + ((vc * _VG) >> 16))
    b, g, r = (yy + ub).clamp(0, 255), (yy + uvg).clamp(0, 255), (yy + vr).clamp(0, 255)
    if gray:
        return ((b * _GRAY_B + g * _GRAY_G + r * _GRAY_R + 16384) >> 15).to(torch.uint8)
    return torch.stack([r, g, b], dim=-1).to(torch.uint8)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """The kernels' library with the conversion's and NVDEC's entry points bound."""
    lib = piv_kernels._library()
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.yuv420_convert_launch.argtypes = [vp, i64, i, vp, vp, i64, i, i, i, i, i, vp, i, vp]
    lib.yuv420_convert_launch.restype = i
    lib.yuv420_convert_path.argtypes = [vp, i64, i, vp, vp, i64, i, i, i, vp]
    lib.yuv420_convert_path.restype = i
    lib.nvdec_load.argtypes = [ctypes.c_char_p, i]
    lib.nvdec_load.restype = i
    lib.nvdec_caps.argtypes = [i, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, i]
    lib.nvdec_caps.restype = i
    lib.nvdec_open.argtypes = [i, i, i, i, i, ctypes.c_char_p, i]
    lib.nvdec_open.restype = vp
    lib.nvdec_decode.argtypes = [vp, vp, vp, vp, i64, vp, i, i64, i64, vp, ctypes.POINTER(i64), ctypes.c_char_p, i]
    lib.nvdec_decode.restype = i64
    lib.nvdec_close.argtypes = [vp]
    lib.nvdec_close.restype = None
    return lib


def _stream_ptr(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def yuv420_to_frames(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, gray: bool) -> torch.Tensor:
    """4:2:0 planes -> the native pump's frames: [n, H, W] gray or [n, H, W, 3] RGB uint8.

    ``y`` is [n, H, W], ``u`` and ``v`` [n, H/2, W/2], uint8, each with unit
    stride along its rows (a view into a larger buffer is taken as it is; the
    rows' pitch and the frames' stride are the kernel's arguments). On a CUDA
    tensor one launch of ``csrc/nv12.cu`` on the current stream, counted in
    :data:`PATHS` by the access path the kernel took (``"16-byte"`` where every
    row lies on a 16-byte boundary, as :func:`i420_planes` of a fresh batch
    at a width that is a multiple of 16; else ``"scalar"``); on a CPU tensor
    :func:`yuv420_to_frames_plain`.
    """
    n, h, w = y.shape
    if u.shape != (n, h // 2, w // 2) or v.shape != u.shape or h % 2 or w % 2:
        raise ValueError(f"planes {tuple(y.shape)}, {tuple(u.shape)}, {tuple(v.shape)} are not 4:2:0 of an even size")
    if any(t.dtype != torch.uint8 for t in (y, u, v)):
        raise ValueError("the planes must be uint8")
    if y.device.type == "cpu":
        piv_kernels.KERNEL_ROUTE[KERNEL] = "plain_cpu"
        return yuv420_to_frames_plain(y, u, v, gray)
    if y.device.type != "cuda" or u.device != y.device or v.device != y.device:
        raise ValueError(f"the planes must lie on one CUDA device, got {y.device}, {u.device}, {v.device}")
    if y.stride(2) != 1 or u.stride(2) != 1 or v.stride(2) != 1 or u.stride() != v.stride():
        raise ValueError("each plane's rows must be contiguous, and u and v laid out alike")
    out = torch.empty((n, h, w) if gray else (n, h, w, 3), dtype=torch.uint8, device=y.device)
    lib = _lib()
    planes = (y.data_ptr(), y.stride(0), y.stride(1), u.data_ptr(), v.data_ptr(), u.stride(0), u.stride(1), 1)
    with torch.cuda.device(y.device):
        rc = lib.yuv420_convert_launch(*planes, n, h, w, out.data_ptr(), int(gray), _stream_ptr(y.device))
    if rc != 0:
        raise RuntimeError(f"yuv420_to_frames: the conversion kernel's launch failed (cudaError {rc})")
    piv_kernels.LAUNCHES[KERNEL] += 1
    PATHS["16-byte" if lib.yuv420_convert_path(*planes, w, out.data_ptr()) else "scalar"] += 1
    piv_kernels.KERNEL_ROUTE[KERNEL] = "cuda"
    return out


def i420_planes(batch: torch.Tensor, h: int, w: int):
    """Views (y, u, v) of a batch of I420 frames [n, 1.5 H W] (libavcodec's planes, back to back)."""
    n = batch.shape[0]
    y = batch[:, : h * w].view(n, h, w)
    u = batch[:, h * w : h * w + h * w // 4].view(n, h // 2, w // 2)
    v = batch[:, h * w + h * w // 4 :].view(n, h // 2, w // 2)
    return y, u, v


def decoder_caps(device) -> Tuple[Optional[dict], Optional[str]]:
    """NVDEC's caps for H.264 4:2:0 8-bit on ``device`` (``cuvidGetDecoderCaps``), or (None, why not)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None, f"the device is {device}, not a card"
    try:
        lib = _lib()
    except (OSError, RuntimeError) as err:
        return None, f"the kernels' library does not build or load: {str(err).splitlines()[0]}"
    msg = ctypes.create_string_buffer(512)
    if lib.nvdec_load(msg, 512) != 0:
        return None, msg.value.decode(errors="replace")
    caps = (ctypes.c_int * 8)()
    index = device.index if device.index is not None else torch.cuda.current_device()
    torch.cuda.init()
    rc = lib.nvdec_caps(index, caps, msg, 512)
    if rc != 0:
        return None, msg.value.decode(errors="replace")
    keys = ("supported", "nvdecs", "output_formats", "max_width", "max_height", "max_macroblocks",
            "min_width", "min_height")
    out = dict(zip(keys, list(caps)))
    if not out["supported"]:
        return out, "cuvidGetDecoderCaps reports no H.264 4:2:0 8-bit decoder on this card"
    return out, None


_CAPS: dict = {}
_CAPS_LOCK = threading.Lock()


def _caps(device: torch.device):
    with _CAPS_LOCK:
        key = str(device)
        if key not in _CAPS:
            _CAPS[key] = decoder_caps(device)
        return _CAPS[key]


def track_for(path: str) -> Tuple[Optional[mp4.Mp4Track], Optional[str]]:
    """The file's first video track and None, or (None or the track, why the card's decoders do not take it)."""
    try:
        track = mp4.open_mp4(path)
    except (mp4.Mp4Error, OSError, struct.error) as err:
        return None, f"not an MP4/MOV the demuxer reads ({err})"
    why = track.refusal()
    return track, why


def plan(path: str, device) -> str:
    """``"nvdec"`` when ``path`` decodes on ``device``'s NVDEC engines, else the reason it does not.

    Decided before any decoding, from the device, the container (:func:`track_for`) and the
    caps (:func:`decoder_caps`): a CUDA device, an MP4/MOV whose first video track the
    demuxer takes (H.264, 4:2:0 8-bit, progressive, limited range, no rotation), within the
    caps' sizes.
    """
    device = torch.device(device)
    if device.type != "cuda":
        return f"the device is {device}, not a card"
    track, why = track_for(path)
    if why is not None:
        return why
    caps, why = _caps(device)
    if why is not None:
        return f"NVDEC unavailable: {why}"
    sps = track.profile
    if not (caps["min_width"] <= sps.coded_width <= caps["max_width"]
            and caps["min_height"] <= sps.coded_height <= caps["max_height"]
            and sps.coded_width * sps.coded_height // 256 <= caps["max_macroblocks"]):
        return f"coded size {sps.coded_width}x{sps.coded_height} outside NVDEC's caps {caps}"
    return "nvdec"


class _CardReader:
    """What both card readers share: the track, its index, the span a read decodes."""

    def __init__(self, path: str, device=None, track: Optional[mp4.Mp4Track] = None):
        self.path = path
        self.device = torch.device(device) if device is not None else _device.get_device()
        if track is None:
            track, why = track_for(path)
            if why is not None:
                raise IOError(f"{path}: the card's decoders do not take it: {why}")
        self.track = track
        self.height, self.width = track.profile.height, track.profile.width
        self.frame_count = track.n_frames
        self._lock = threading.Lock()

    def timestamps(self) -> np.ndarray:
        """Each frame's time in ms from the container (OpenCV's ``CAP_PROP_POS_MSEC``)."""
        return self.track.timestamps_ms()

    def _span(self, start: int, count: int):
        d0, d1 = self.track.decode_span(start, count)
        data, sizes = self.track.access_units(d0, d1)
        return d0, d1, data, sizes

    def close(self) -> None:
        pass


class NvdecVideoReader(_CardReader):
    """Frames of an H.264 MP4 decoded by NVDEC, as uint8 tensors on the card."""

    def __init__(self, path: str, device=None, track: Optional[mp4.Mp4Track] = None):
        super().__init__(path, device, track)
        if self.device.type != "cuda":
            raise RuntimeError(f"NVDEC decodes on a card, not on {self.device}")
        msg = ctypes.create_string_buffer(512)
        sps = self.track.profile
        index = self.device.index if self.device.index is not None else torch.cuda.current_device()
        torch.cuda.init()
        self._handle = _lib().nvdec_open(index, sps.coded_width, sps.coded_height, self.width, self.height, msg, 512)
        if not self._handle:
            raise RuntimeError(f"{path}: NVDEC session failed: {msg.value.decode(errors='replace')}")

    def read(self, start: int, count: int, gray: bool = True) -> torch.Tensor:
        """Frames [start, start + count) -> uint8 [count, H, W] (gray) or [count, H, W, 3] (RGB) on the card,
        written on the current stream. Raises RuntimeError with the decoder's status on any failure."""
        d0, d1, data, sizes = self._span(start, count)
        stamps = np.ascontiguousarray(self.track.rank[d0:d1])
        shape = (count, self.height, self.width) if gray else (count, self.height, self.width, 3)
        out = torch.empty(shape, dtype=torch.uint8, device=self.device)
        msg = ctypes.create_string_buffer(1024)
        launches = ctypes.c_int64(0)
        with self._lock, torch.cuda.device(self.device):
            got = _lib().nvdec_decode(
                self._handle, data.ctypes.data, sizes.ctypes.data, stamps.ctypes.data, sizes.size,
                out.data_ptr(), int(gray), start, count, _stream_ptr(self.device), ctypes.byref(launches), msg, 1024,
            )
        piv_kernels.LAUNCHES[KERNEL] += launches.value
        _device._count("h2d", data.nbytes)  # the bitstream handed to the decoder
        if got != count:
            raise RuntimeError(f"{self.path}: NVDEC decode of frames [{start}, {start + count}) failed: "
                               f"{msg.value.decode(errors='replace')}")
        piv_kernels.KERNEL_ROUTE[KERNEL] = "cuda"
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            _lib().nvdec_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class LibavVideoReader(_CardReader):
    """Frames of an H.264 MP4 decoded by libavcodec to YUV on the host and converted on ``device``."""

    def __init__(self, path: str, device=None, track: Optional[mp4.Mp4Track] = None):
        from . import libav

        super().__init__(path, device, track)
        self._decoder = libav.LibavDecoder(self.width, self.height)

    def read(self, start: int, count: int, gray: bool = True, uploader=None) -> torch.Tensor:
        """Frames [start, start + count) -> uint8 [count, H, W] (gray) or [count, H, W, 3] (RGB) on the
        device. The planes go up through ``uploader`` (a :class:`~pyorc_tpu_torch._device.PinnedUploader`)
        where one is given, else as a pageable copy; raises IOError on a decoder failure."""
        d0, d1, data, sizes = self._span(start, count)
        with self._lock:
            planes = self._decoder.decode(data, sizes, self.track.output_frames(d0, d1), start, count,
                                          self.track.sync[d0:d1])
        batch = uploader.upload(planes) if uploader is not None else _device.to_device(planes, self.device)
        return yuv420_to_frames(*i420_planes(batch, self.height, self.width), gray)

    def close(self) -> None:
        if getattr(self, "_decoder", None) is not None:
            self._decoder.close()
            self._decoder = None
