"""ctypes bindings for the native FFmpeg decode pump (``native/decoder.cpp``).

Port of :mod:`pyorc_tpu.io.native_decoder`. The port compiles the repo's
``native/decoder.cpp`` itself, with the flags and libraries of
``native/Makefile``, into its own ``build/pyorc_tpu_torch/`` (keyed by a hash
of the source, the flags and the host CPU, since ``-march=native`` ties the
library to it); it neither writes into ``native/`` nor loads the library the
JAX package builds there. Callers check :func:`available`; :func:`load_error`
says why the library is missing (no compiler, no FFmpeg headers, ...).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "NativeVideoReader",
    "ParallelVideoReader",
    "NativeVideoWriter",
    "available",
    "encoder_available",
    "build_library",
    "load_error",
]

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "decoder.cpp"
_BUILD_DIR = _ROOT / "build" / "pyorc_tpu_torch"
# native/Makefile's CXXFLAGS and LIBS
_CXXFLAGS = ["-O3", "-fPIC", "-Wall", "-march=native", "-funroll-loops"]
_LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]

_LIB: Optional[ctypes.CDLL] = None
_LOAD_ERROR: Optional[str] = None
_LIB_LOCK = threading.Lock()


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def _cpu_identity() -> bytes:
    """The host CPU's model and flags: what ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            return "".join(line for line in f if line.startswith(("model name", "flags"))).encode()
    except OSError:
        return os.uname().machine.encode()


def build_library() -> Path:
    """Compile ``native/decoder.cpp`` (once per source, flags and CPU) and return the library's path.

    Raises RuntimeError with the compiler's output when it fails or is absent.
    """
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError(f"no C++ compiler ({os.environ.get('CXX', 'g++')}) on PATH")
    digest = hashlib.sha256(" ".join(_CXXFLAGS + _LIBS).encode() + _SOURCE.read_bytes() + _cpu_identity())
    lib = _BUILD_DIR / f"libpyorc_decoder-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [cxx, *_CXXFLAGS, "-shared", str(_SOURCE), "-o", str(tmp), *_LIBS],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed to build {_SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.vd_open.restype = ctypes.c_void_p
    lib.vd_open.argtypes = [ctypes.c_char_p]
    lib.vd_meta.restype = ctypes.c_int
    lib.vd_meta.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vd_read.restype = ctypes.c_int64
    lib.vd_read.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.vd_close.restype = None
    lib.vd_close.argtypes = [ctypes.c_void_p]
    lib.vd_timestamps.restype = ctypes.c_int64
    lib.vd_timestamps.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.ve_open.restype = ctypes.c_void_p
    lib.ve_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.ve_write.restype = ctypes.c_int
    lib.ve_write.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.ve_close.restype = ctypes.c_int
    lib.ve_close.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None (with :func:`load_error` set) when it cannot be."""
    global _LIB, _LOAD_ERROR
    with _LIB_LOCK:
        if _LIB is None and _LOAD_ERROR is None:
            try:
                _LIB = _bind(ctypes.CDLL(str(build_library())))
            except (RuntimeError, OSError, subprocess.SubprocessError) as err:
                _LOAD_ERROR = str(err).strip() or type(err).__name__
        return _LIB


def available() -> bool:
    return _load() is not None


def encoder_available() -> bool:
    return available()


def load_error() -> Optional[str]:
    """Why the native library is unavailable (the build's or loader's message), or None."""
    _load()
    return _LOAD_ERROR


class NativeVideoReader:
    """Sequential/seekable frame reader over the native decoder."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native decoder unavailable: {_LOAD_ERROR}")
        self._lib = lib
        self._handle = lib.vd_open(path.encode())
        if not self._handle:
            raise IOError(f"native decoder could not open {path}")
        fps = ctypes.c_double()
        n = ctypes.c_int64()
        w = ctypes.c_int()
        h = ctypes.c_int()
        lib.vd_meta(self._handle, ctypes.byref(fps), ctypes.byref(n), ctypes.byref(w), ctypes.byref(h))
        self.fps = fps.value
        self.frame_count = int(n.value)
        self.width = int(w.value)
        self.height = int(h.value)
        self._lock = threading.Lock()

    def read(self, start: int, count: int, gray: bool = True) -> np.ndarray:
        """Decode frames [start, start+count) -> uint8 [count, H, W(, 3)]."""
        ch = 1 if gray else 3
        out = np.empty((count, self.height, self.width * ch), dtype=np.uint8)
        with self._lock:
            got = self._lib.vd_read(
                self._handle,
                int(start),
                int(count),
                1 if gray else 0,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
        if got < count:
            out = out[: max(int(got), 0)]
        if gray:
            return out
        return out.reshape(-1, self.height, self.width, 3)

    def timestamps(self) -> Optional[np.ndarray]:
        """Per-frame presentation times in ms (packet scan, no decoding)."""
        cap = max(self.frame_count * 2, 1024)
        out = np.empty(cap, dtype=np.float64)
        with self._lock:
            n = self._lib.vd_timestamps(self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap)
        if n <= 0:
            return None
        return out[:n].copy()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.vd_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ParallelVideoReader:
    """GOP-parallel batch decode: N workers each seek to a keyframe and decode
    a contiguous segment (one FFmpeg decoder instance per worker, the
    interpreter lock released inside ``vd_read``)."""

    def __init__(self, path: str, workers: int = 4):
        if not available():
            raise RuntimeError(f"native decoder unavailable: {_LOAD_ERROR}")
        self._path = path
        self._workers = max(int(workers), 1)
        self._readers = [NativeVideoReader(path) for _ in range(self._workers)]
        r0 = self._readers[0]
        self.fps = r0.fps
        self.frame_count = r0.frame_count
        self.width = r0.width
        self.height = r0.height

    def read(self, start: int, count: int, gray: bool = True) -> np.ndarray:
        import concurrent.futures as cf

        n_seg = min(self._workers, max(count, 1))
        bounds = np.linspace(start, start + count, n_seg + 1).astype(int)
        segs = [(int(a), int(b - a)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        with cf.ThreadPoolExecutor(max_workers=len(segs)) as ex:
            futs = [ex.submit(self._readers[i].read, s0, cnt, gray) for i, (s0, cnt) in enumerate(segs)]
            out = [f.result() for f in futs]
        return np.concatenate(out, axis=0)

    def close(self):
        for r in self._readers:
            r.close()
        self._readers = []

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeVideoWriter:
    """H.264 (libx264) mp4 writer over the native library."""

    def __init__(self, path: str, width: int, height: int, fps: float = 25.0, channels: int = 1, crf: int = 18):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native encoder unavailable: {_LOAD_ERROR}")
        self._lib = lib
        self._channels = 3 if channels == 3 else 1
        self._shape = (height, width) if self._channels == 1 else (height, width, 3)
        self._handle = lib.ve_open(path.encode(), int(width), int(height), float(fps), self._channels, int(crf))
        if not self._handle:
            raise IOError(f"native encoder could not open {path}")

    def write(self, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.shape != self._shape:
            raise ValueError(f"frame shape {frame.shape} != {self._shape}")
        rc = self._lib.ve_write(self._handle, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise IOError(f"native encoder write failed (rc={rc})")

    def close(self) -> None:
        if self._handle:
            rc = self._lib.ve_close(self._handle)
            self._handle = None
            if rc != 0:
                raise IOError(f"native encoder close failed (rc={rc})")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
