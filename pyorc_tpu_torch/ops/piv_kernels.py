"""PIV on the GPU: the hand-written CUDA kernels and their plain versions.

Counterpart of :mod:`pyorc_tpu.ops.piv_pallas`. The TPU package runs two
contracts through five Pallas kernels chosen by geometry; here each contract
is one CUDA kernel under ``pyorc_tpu_torch/csrc/``:

- ``piv_pairs_fused`` (``csrc/piv_pairs.cu``, Pallas B1-B3): per-pair PIV,

      frames [T, H, W] (uint8 or float32) -> (u, v, corr_max, s2n),
      each float32 [n_pairs, n_rows, n_cols]

  with ``n_pairs = T - 1`` for consecutive frames (``pair_stride=1``) or
  ``T // 2`` for interleaved explicit pairs (``pair_stride=2``, what
  multipass PIV gives it). Its semantics are those of the Pallas kernels
  (``piv_pallas._finish_corr`` and the NaN stores): a window pair with a
  zero-variance window gives NaN ``u``/``v``, ``corr_max = 0`` and
  ``s2n = 0`` (the guarded ``max / max(mean, 1e-10)``). With
  ``signal_threshold`` set, a pair whose smaller fraction of non-zero pixels
  falls below it gives NaN in all four outputs.
- ``piv_ensemble_fused`` (``csrc/piv_ensemble.cu``, Pallas B4-B5): ensemble
  PIV, the contract of :func:`pyorc_tpu_torch.ops.piv.piv_ensemble_scan`,

      frames [T, H, W] -> (corr_sum [n_windows, wy, wx], corr_count [n_windows],
                           corr_max [T-1, n_rows, n_cols], s2n [T-1, n_rows, n_cols])

Both kernels take wy x wx windows with each side from ``MIN_WINDOW`` to
``MAX_WINDOW`` px (8-128), square or not, on any uniform step
(:func:`kernel_takes`): every geometry the Pallas kernels take. Each wrapper
launches its kernel for a CUDA tensor, or raises; for a CPU tensor it runs
its plain PyTorch version (``*_plain``). A side outside 8-128 px raises on
CUDA. ``piv_pairs_routed`` and ``piv_ensemble_routed`` are what the engine
and multipass call: by plan, windows the kernels do not take go to the
XLA-semantics pipeline of :mod:`pyorc_tpu_torch.ops.piv`, as the JAX package
sends them to its XLA pipeline (``piv_pallas.py:1514-1521``, ``:2079-2083``),
and the route is recorded as ``"torch_ops"``. Per-pair calls on that route run
in row-band strips (``piv.piv_pairs_strips``), as the JAX package's engine
runs its XLA route, so the planes of one call stay within 256 MiB.

Both kernels share one design (``csrc/piv_common.cuh``): a thread block keeps
one complex wy x wx plane in shared memory, packs two real windows into it
(z = a + i b), and transforms it in place with an in-block FFT whose
butterflies live in registers: per axis, for a length 2^a m with m <= 15, an
m-point pass and radix-8/4/2 passes, one shared-memory exchange per pass; an
axis with a larger odd part (17, 66, 75, 127, ...) runs a table DFT along that
axis instead, so every side of 8-128 px stays on a hand-written kernel. The
spectra are separated by Hermitian symmetry. The ensemble kernel caches the
last frame's half spectrum, so each frame is transformed once, gets two
pairs' correlation planes out of each inverse transform, and keeps its gated
sum in registers. What bounds them on the H100 is shared-memory bandwidth
(every FFT pass reads and writes the plane) and, at 16-32 px, a block's fixed
costs; device memory is read about four to eight times per frame byte and is
far from its limit. fp32 on the CUDA cores throughout: TF32 and the tensor
cores miss the 0.01 m/s velocity bar, and the twiddles come from the float64
tables this module makes (:func:`_dft_tables`), never from fast intrinsics.
The window sizes of the main paths (16, 26, 32, 52, 64, 104, 128 and 64x128
px) each get a kernel built for that size; any other size runs one kernel
that takes its plan as a run-time value.

A pair's result does not depend on how a stack is split into launches: the
kernels fix every packing partner (the frame beside a frame in a forward
transform, the pair beside a pair in an inverse) by absolute position in the
whole stack. A caller that cuts a stack (the engine's chunks, a chunk's
out-of-memory halves, a lazy stack's batches, the sharded functions' pair
shards) passes each piece as a :class:`Span`: its frames, the absolute index
of its first frame, its halo (the frames around its pairs that the kernel
reads and pairs no further: :data:`HALO`, :func:`Span.cut`) and the whole
stack's frame count, so that a launch can tell a missing halo frame from the
stack's end; :meth:`Span.place` gives the keywords. The pieces then
give, bit for bit, the per-pair outputs of one launch over the whole stack
(the ensemble's ``corr_sum`` is a sum of the pieces' partial sums).

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use into one
library under ``build/pyorc_tpu_torch/`` and loaded with ``ctypes``. The same
library holds a third kernel, multipass PIV's window deformation
(``csrc/deform.cu``), whose wrapper is
:func:`pyorc_tpu_torch.ops.multipass.deformed_pairs` and whose launches count
in :data:`LAUNCHES` as ``"deform_pairs"``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from . import piv as piv_ops
from . import windows as win

__all__ = [
    "piv_pairs_fused",
    "piv_pairs_fused_plain",
    "piv_ensemble_fused",
    "piv_ensemble_fused_plain",
    "piv_pairs_routed",
    "piv_ensemble_routed",
    "piv_pairs_engine",
    "piv_ensemble_engine",
    "kernel_takes",
    "Span",
    "HALO",
    "KERNEL_ROUTE",
    "LAUNCHES",
    "build_library",
    "MIN_WINDOW",
    "MAX_WINDOW",
]

# Route the last call of each entry point took: "cuda" (the kernel),
# "plain_cpu" (the plain version on a CPU tensor) or "torch_ops" (a window
# the kernels do not take, by plan). Tests and the chip smoke
# run assert on it, so a path that skips the kernel cannot pass unnoticed.
KERNEL_ROUTE: dict = {}
# Launches of each kernel since import (or since a caller reset them to 0);
# only the kernel launch sites add to them.
LAUNCHES = {"piv_pairs": 0, "piv_ensemble": 0, "deform_pairs": 0}

MIN_WINDOW = 8
MAX_WINDOW = 128

# Frames a launch reads before its first pair and after its last pair's second
# frame, where the stack has them: a pair's packing partners reach two frames
# back (the cached spectrum of the pair beside it in the inverse) and one
# forward (the frame beside its second frame in a forward transform).
HALO = (2, 1)


class Span(NamedTuple):
    """A piece of a frame stack for one launch.

    ``frames`` [T, ...] (numpy or tensor) are frames ``frame0 .. frame0 + T - 1``
    of the whole stack of ``n_total`` frames (default: the piece ends the
    stack, ``frame0 + T``); the first ``halo[0]`` and the last ``halo[1]`` of
    them are read and not paired, so the piece's pairs are the
    ``T - 1 - sum(halo)`` pairs between the others.
    """

    frames: object
    frame0: int = 0
    halo: Tuple[int, int] = (0, 0)
    n_total: Optional[int] = None

    @property
    def total(self) -> int:
        """The whole stack's frame count."""
        return self.frame0 + self.frames.shape[0] if self.n_total is None else self.n_total

    def place(self) -> dict:
        """The piece's place in the stack, as the launch functions' keywords."""
        return {"frame0": self.frame0, "halo": self.halo, "n_total": self.total}

    @property
    def n_pairs(self) -> int:
        return self.frames.shape[0] - 1 - self.halo[0] - self.halo[1]

    def own(self):
        """The frames of the piece's own pairs, without the halo."""
        return self.frames[self.halo[0] : self.frames.shape[0] - self.halo[1]]

    def cut(self, p0: int, p1: int) -> "Span":
        """Pairs ``p0 .. p1 - 1`` of this piece (counted from its first pair) with
        their :data:`HALO` as far as the piece's frames hold it."""
        if not 0 <= p0 < p1 <= self.n_pairs:
            raise ValueError(f"pairs [{p0}, {p1}) outside a piece of {self.n_pairs} pairs")
        a, b = self.halo[0] + p0, self.halo[0] + p1  # local frames of the first pair, of the last pair's second
        f0, f1 = max(0, a - HALO[0]), min(self.frames.shape[0], b + 1 + HALO[1])
        return Span(self.frames[f0:f1], self.frame0 + f0, (a - f0, f1 - 1 - b), self.total)

    def to(self, device) -> "Span":
        from .._device import to_device

        return self._replace(frames=to_device(self.frames, device))


_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pyorc_tpu_torch"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "--split-compile=0", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` into one library (once per hash of all sources) and return its path.

    One ``nvcc -c`` per source runs in parallel, then one ``nvcc -shared``
    links the objects. The compilers' ``-Xptxas -v`` reports (registers,
    shared memory, spills) are kept beside the library as ``<name>.log``.
    """
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    lib = _BUILD_DIR / f"libpyorc_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [_BUILD_DIR / f"{src.stem}-{tag}.o" for src in sources]
    procs = [
        subprocess.Popen(
            [_nvcc(), *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    reports = [(src, proc, proc.communicate()[0]) for src, proc in zip(sources, procs)]
    for src, proc, out in reports:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n{out}")
    tmp = _BUILD_DIR / f"{tag}.tmp"
    link = subprocess.run(
        [_nvcc(), *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link {lib.name}:\n{link.stdout}\n{link.stderr}")
    lib.with_suffix(".log").write_text("".join(f"== {src.name}\n{out}" for src, _, out in reports))
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink()
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.piv_pairs_launch
    fn.argtypes = [
        ctypes.c_void_p,  # frames
        ctypes.c_int,  # frames are uint8 (1) or float32 (0)
        ctypes.c_int, ctypes.c_int,  # H, W
        ctypes.c_int, ctypes.c_int,  # wy, wx
        ctypes.c_int, ctypes.c_int,  # step_y, step_x
        ctypes.c_int, ctypes.c_int,  # n_rows, n_cols
        ctypes.c_int, ctypes.c_int,  # frame0 (absolute index of the first frame), n_frames
        ctypes.c_int, ctypes.c_int,  # pair0 (absolute index of the first pair), n_pairs
        ctypes.c_int,  # pair_stride
        ctypes.c_int, ctypes.c_float,  # has_threshold, signal_threshold
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # cos/sin tables of y, of x
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # u, v, cmax, s2n
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    fn = lib.piv_ensemble_launch
    fn.argtypes = [
        ctypes.c_void_p,  # frames
        ctypes.c_int,  # frames are uint8 (1) or float32 (0)
        ctypes.c_int, ctypes.c_int,  # H, W
        ctypes.c_int, ctypes.c_int,  # wy, wx
        ctypes.c_int, ctypes.c_int,  # step_y, step_x
        ctypes.c_int, ctypes.c_int,  # n_rows, n_cols
        ctypes.c_int, ctypes.c_int,  # frame0 (absolute index of the first frame), n_frames
        ctypes.c_int, ctypes.c_int,  # pair0 (absolute index of the first pair), n_pairs
        ctypes.c_float, ctypes.c_float,  # corr_min, s2n_min
        ctypes.c_int, ctypes.c_float,  # has_threshold, signal_threshold
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # cos/sin tables of y, of x
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # corr_sum, count, cmax, s2n
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    fn = lib.deform_pairs_launch  # ops/multipass.py::deformed_pairs
    fn.argtypes = [
        ctypes.c_void_p,  # frames [T, H, W] float32
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n_pairs (T - 1), H, W
        ctypes.c_void_p, ctypes.c_void_p,  # u, v [n_pairs, n_rows, n_cols]
        ctypes.c_int, ctypes.c_int,  # n_rows, n_cols
        ctypes.c_void_p, ctypes.c_void_p,  # rr [H], cc [W]: pixel rows and columns in the grid's index space
        ctypes.c_void_p,  # pairs [2 n_pairs, H, W]
        ctypes.c_void_p,  # (tile, pair)s past the staged halo: one uint64, added to
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    fn = lib.deform_pairs_geometry
    fn.argtypes = [ctypes.c_void_p]  # int[7]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _dft_tables(n: int, device: torch.device):
    """float32 cos/sin tables of the n-point DFT (made in float64) on ``device``."""
    c, s = piv_ops._dft_mats(n)
    return torch.as_tensor(c, device=device), torch.as_tensor(s, device=device)


def _grid_steps(dim_size, sas, overlap, n_rows, n_cols):
    """(step_y, step_x) of the window grid, checked against (n_rows, n_cols)."""
    if (n_rows, n_cols) != win.get_field_shape(dim_size, sas, overlap):
        raise ValueError(
            f"(n_rows, n_cols)={(n_rows, n_cols)} does not match the window grid of "
            f"{tuple(dim_size)} at window {tuple(sas)}, overlap {tuple(overlap)}"
        )
    return sas[0] - overlap[0], sas[1] - overlap[1]


def kernel_takes(sas) -> bool:
    """Whether the CUDA kernels take wy x wx windows ``sas``: each side of
    MIN_WINDOW-MAX_WINDOW px, square or not (the plan the engine and
    multipass check before any launch)."""
    wy, wx = win._as2(sas)
    return MIN_WINDOW <= wy <= MAX_WINDOW and MIN_WINDOW <= wx <= MAX_WINDOW


def _kernel_frames(imgs, sas, name):
    """Check what the kernels take (sides of MIN_WINDOW-MAX_WINDOW px, a
    [T, H, W] stack); return the frames as a contiguous uint8 or float32 tensor."""
    if not kernel_takes(sas):
        raise ValueError(
            f"{name}: the CUDA kernel takes windows with sides of {MIN_WINDOW}-{MAX_WINDOW} px, "
            f"got {sas[0]}x{sas[1]} (larger windows go to the plain tensor ops by plan: "
            f"piv_pairs_routed / piv_ensemble_routed; ROADMAP.md, queue B)"
        )
    if imgs.dim() != 3:
        raise ValueError(f"{name}: frames must be [T, H, W], got shape {tuple(imgs.shape)}")
    if imgs.dtype not in (torch.uint8, torch.float32):
        imgs = imgs.to(torch.float32)
    return imgs.contiguous()


def _tables(sas, device):
    """(cos_y, sin_y, cos_x, sin_x) device pointers of the DFT tables of both axes."""
    return [t.data_ptr() for n in sas for t in _dft_tables(n, device)]


def _check_halo(frame0, halo, n_total, n_frames, pair_stride, name):
    """The launch's first absolute pair; raises where the halo is short of what the kernel must read.

    ``n_total`` is the whole stack's frame count; a launch given no place
    (``frame0`` 0, no halo) may leave it out and is then the whole stack.
    """
    frame0, (h0, h1) = int(frame0), (int(halo[0]), int(halo[1]))
    if frame0 < 0 or h0 < 0 or h1 < 0:
        raise ValueError(f"{name}: frame0={frame0}, halo={halo} must not be negative")
    if pair_stride != 1 and (frame0, h0, h1) != (0, 0, 0):
        raise ValueError(f"{name}: explicit pairs (pair_stride={pair_stride}) take no frame0 or halo")
    if n_total is None:
        if (frame0, h0, h1) != (0, 0, 0):
            raise ValueError(f"{name}: a piece of a stack (frame0, halo) needs n_total, the stack's frame count "
                             "(Span.place gives it)")
        n_total = n_frames
    end = frame0 + n_frames  # the absolute index after the launch's last frame
    if n_total < end:
        raise ValueError(f"{name}: frames {frame0} .. {end - 1} lie outside a stack of {n_total} frames")
    if h0 < min(HALO[0], frame0 + h0):
        raise ValueError(
            f"{name}: pairs from absolute pair {frame0 + h0} need {min(HALO[0], frame0 + h0)} frames of "
            f"halo before them, got {h0} (Span.cut gives them)"
        )
    if h1 < min(HALO[1], n_total - end + h1):
        raise ValueError(
            f"{name}: pairs up to absolute frame {end - 1 - h1} of a stack of {n_total} frames need "
            f"{min(HALO[1], n_total - end + h1)} frames of halo after them, got {h1} (Span.cut gives them)"
        )
    return frame0 + h0


def _launch(imgs, sas, steps, n_rows, n_cols, signal_threshold, pair_stride, frame0=0, halo=(0, 0), n_total=None):
    imgs = _kernel_frames(imgs, sas, "piv_pairs_fused")
    t, h, w = imgs.shape
    pair0 = _check_halo(frame0, halo, n_total, t, pair_stride, "piv_pairs_fused")
    n_pairs = t - 1 - halo[0] - halo[1] if pair_stride == 1 else t // pair_stride
    if n_pairs < 1 or n_pairs > 65535:
        raise ValueError(f"piv_pairs_fused: {n_pairs} pairs per launch; the kernel takes 1-65535")
    device = imgs.device
    outs = [torch.empty((n_pairs, n_rows, n_cols), dtype=torch.float32, device=device) for _ in range(4)]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _library().piv_pairs_launch(
            imgs.data_ptr(), int(imgs.dtype == torch.uint8), h, w, sas[0], sas[1], steps[0], steps[1],
            n_rows, n_cols, int(frame0), t, pair0, n_pairs, pair_stride,
            int(signal_threshold is not None), float(signal_threshold or 0.0),
            *_tables(sas, device), *(o.data_ptr() for o in outs), stream,
        )
    if err != 0:
        raise RuntimeError(f"piv_pairs_fused: CUDA kernel launch failed (cudaError {err})")
    LAUNCHES["piv_pairs"] += 1
    return tuple(outs)


def _launch_ensemble(imgs, sas, steps, n_rows, n_cols, corr_min, s2n_min, signal_threshold, frame0=0, halo=(0, 0),
                     n_total=None):
    imgs = _kernel_frames(imgs, sas, "piv_ensemble_fused")
    t, h, w = imgs.shape
    pair0 = _check_halo(frame0, halo, n_total, t, 1, "piv_ensemble_fused")
    n_pairs = t - 1 - halo[0] - halo[1]
    if n_pairs < 1:
        raise ValueError(f"piv_ensemble_fused: {n_pairs} pairs per launch; the kernel needs at least 2 frames, one pair")
    device = imgs.device
    corr_sum = torch.empty((n_rows * n_cols, sas[0], sas[1]), dtype=torch.float32, device=device)
    count = torch.empty((n_rows * n_cols,), dtype=torch.float32, device=device)
    cmax, s2n = (torch.empty((n_pairs, n_rows, n_cols), dtype=torch.float32, device=device) for _ in range(2))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _library().piv_ensemble_launch(
            imgs.data_ptr(), int(imgs.dtype == torch.uint8), h, w, sas[0], sas[1], steps[0], steps[1],
            n_rows, n_cols, int(frame0), t, pair0, n_pairs, float(corr_min), float(s2n_min),
            int(signal_threshold is not None), float(signal_threshold or 0.0),
            *_tables(sas, device),
            corr_sum.data_ptr(), count.data_ptr(), cmax.data_ptr(), s2n.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"piv_ensemble_fused: CUDA kernel launch failed (cudaError {err})")
    LAUNCHES["piv_ensemble"] += 1
    return corr_sum, count, cmax, s2n


def _own(imgs, frame0, halo, n_total, pair_stride, name):
    """The frames of a launch's own pairs (its halo dropped), for the routes that pair frames one by one."""
    _check_halo(frame0, halo, n_total, imgs.shape[0], pair_stride, name)
    return imgs[halo[0] : imgs.shape[0] - halo[1]]


def piv_pairs_fused(
    imgs: torch.Tensor,
    dim_size,
    sas,
    overlap,
    n_rows: int,
    n_cols: int,
    signal_threshold: Optional[float] = None,
    pair_stride: int = 1,
    frame0: int = 0,
    halo: Tuple[int, int] = (0, 0),
    n_total: Optional[int] = None,
):
    """Per-pair PIV: frames [T, H, W] -> (u, v, corr_max, s2n), each [n_pairs, n_rows, n_cols].

    A CUDA tensor launches the CUDA kernel; a geometry the kernel does not
    take raises. A CPU tensor runs :func:`piv_pairs_fused_plain`. ``frame0``,
    ``halo`` and ``n_total`` place the frames in a stack of ``n_total``
    frames (:meth:`Span.place`): the pairs are those between the halo's
    frames, and each gives the bits of one launch over the whole stack; a
    halo short of what the stack holds raises.
    """
    sas = win._as2(sas)
    overlap = win._as2(overlap)
    if pair_stride not in (1, 2):
        raise ValueError(f"pair_stride must be 1 or 2, got {pair_stride}")
    if tuple(imgs.shape[-2:]) != tuple(dim_size):
        raise ValueError(f"frames of shape {tuple(imgs.shape)} do not match dim_size {tuple(dim_size)}")
    steps = _grid_steps(dim_size, sas, overlap, n_rows, n_cols)
    if imgs.device.type == "cuda":
        out = _launch(imgs, sas, steps, n_rows, n_cols, signal_threshold, pair_stride, frame0, halo, n_total)
        KERNEL_ROUTE["piv_pairs_fused"] = "cuda"
        return out
    if imgs.device.type != "cpu":
        raise ValueError(f"piv_pairs_fused: no kernel for device {imgs.device}")
    KERNEL_ROUTE["piv_pairs_fused"] = "plain_cpu"
    return piv_pairs_fused_plain(
        imgs, dim_size, sas, overlap, n_rows, n_cols, signal_threshold, pair_stride, frame0, halo, n_total
    )


def piv_pairs_fused_plain(
    imgs: torch.Tensor,
    dim_size,
    sas,
    overlap,
    n_rows: int,
    n_cols: int,
    signal_threshold: Optional[float] = None,
    pair_stride: int = 1,
    frame0: int = 0,
    halo: Tuple[int, int] = (0, 0),
    n_total: Optional[int] = None,
):
    """The kernel's contract in plain PyTorch (``torch.fft``), on any device.

    Built from :mod:`pyorc_tpu_torch.ops.piv` plus the two points where the
    Pallas kernels differ from the XLA pipeline: ``u``/``v`` are NaN where a
    window has zero variance, and ``s2n = max / max(mean, 1e-10)``. Each pair
    is computed on its own, so ``frame0``, ``halo`` and ``n_total`` only
    drop the halo.
    """
    imgs = _own(imgs, frame0, halo, n_total, pair_stride, "piv_pairs_fused_plain")
    if imgs.device.type == "cuda":
        # TF32 keeps ~3 decimal digits, short of the 0.01 m/s velocity bar
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sas = win._as2(sas)
    overlap = win._as2(overlap)
    wa, wb = piv_ops._pair_windows(imgs, dim_size, sas, overlap, pair_stride)
    corr, valid = piv_ops._normalized_corr_planes(wa, wb)
    flat = corr.flatten(-2)
    cmax = flat.amax(dim=-1)
    s2n = cmax / torch.clamp(flat.mean(dim=-1), min=1e-10)
    u, v = piv_ops.u_v_displacement(corr, n_rows, n_cols)
    shape = (-1, n_rows, n_cols)
    invalid = ~valid.reshape(shape)
    u = torch.where(invalid, torch.nan, u)
    v = torch.where(invalid, torch.nan, v)
    cmax = cmax.reshape(shape)
    s2n = s2n.reshape(shape)
    if signal_threshold is not None:
        low = (piv_ops._pair_signal(wa, wb) < signal_threshold).reshape(shape)
        u, v, cmax, s2n = (torch.where(low, torch.nan, x) for x in (u, v, cmax, s2n))
    return u, v, cmax, s2n


def piv_ensemble_fused(
    imgs: torch.Tensor,
    dim_size,
    sas,
    overlap,
    n_rows: int,
    n_cols: int,
    corr_min: float = 0.2,
    s2n_min: float = 3.0,
    signal_threshold: Optional[float] = None,
    frame0: int = 0,
    halo: Tuple[int, int] = (0, 0),
    n_total: Optional[int] = None,
):
    """Ensemble PIV: frames [T, H, W] -> (corr_sum [n_windows, wy, wx],
    corr_count [n_windows], corr_max [n_pairs, n_rows, n_cols], s2n [n_pairs, n_rows, n_cols]).

    A CUDA tensor launches the CUDA kernel (one launch for the stack); a
    geometry the kernel does not take raises. A CPU tensor runs
    :func:`piv_ensemble_fused_plain`. ``frame0``, ``halo`` and ``n_total`` as in
    :func:`piv_pairs_fused`: per-pair ``corr_max``, ``s2n`` and gates of
    one launch over the whole stack, and that launch's partial sums.
    """
    sas = win._as2(sas)
    overlap = win._as2(overlap)
    if tuple(imgs.shape[-2:]) != tuple(dim_size):
        raise ValueError(f"frames of shape {tuple(imgs.shape)} do not match dim_size {tuple(dim_size)}")
    steps = _grid_steps(dim_size, sas, overlap, n_rows, n_cols)
    if imgs.device.type == "cuda":
        out = _launch_ensemble(
            imgs, sas, steps, n_rows, n_cols, corr_min, s2n_min, signal_threshold, frame0, halo, n_total
        )
        KERNEL_ROUTE["piv_ensemble_fused"] = "cuda"
        return out
    if imgs.device.type != "cpu":
        raise ValueError(f"piv_ensemble_fused: no kernel for device {imgs.device}")
    KERNEL_ROUTE["piv_ensemble_fused"] = "plain_cpu"
    return piv_ensemble_fused_plain(
        imgs, dim_size, sas, overlap, n_rows, n_cols, corr_min, s2n_min, signal_threshold, frame0, halo, n_total
    )


def piv_ensemble_fused_plain(
    imgs: torch.Tensor,
    dim_size,
    sas,
    overlap,
    n_rows: int,
    n_cols: int,
    corr_min: float = 0.2,
    s2n_min: float = 3.0,
    signal_threshold: Optional[float] = None,
    frame0: int = 0,
    halo: Tuple[int, int] = (0, 0),
    n_total: Optional[int] = None,
):
    """The kernel's contract in plain PyTorch (``torch.fft``), on any device:
    :func:`pyorc_tpu_torch.ops.piv.piv_ensemble_scan`, with TF32 off on the
    card, over the pairs between the halo's frames."""
    imgs = _own(imgs, frame0, halo, n_total, 1, "piv_ensemble_fused_plain")
    if imgs.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return piv_ops.piv_ensemble_scan(
        imgs, dim_size, win._as2(sas), win._as2(overlap), n_rows, n_cols, corr_min, s2n_min, signal_threshold
    )


def piv_pairs_routed(
    imgs: torch.Tensor,
    dim_size,
    sas,
    overlap,
    n_rows: int,
    n_cols: int,
    signal_threshold: Optional[float] = None,
    pair_stride: int = 1,
    frame0: int = 0,
    halo: Tuple[int, int] = (0, 0),
    n_total: Optional[int] = None,
):
    """Per-pair PIV by plan: :func:`piv_pairs_fused` where :func:`kernel_takes`
    the windows, else :func:`pyorc_tpu_torch.ops.piv.piv_pairs` (the XLA
    pipeline's semantics, as the JAX package routes such windows), recorded
    as route ``"torch_ops"``. Never a fallback: a kernel that fails raises."""
    if kernel_takes(sas):
        return piv_pairs_fused(
            imgs, dim_size, sas, overlap, n_rows, n_cols, signal_threshold, pair_stride=pair_stride, frame0=frame0,
            halo=halo, n_total=n_total,
        )
    return _pairs_torch_ops(
        imgs, dim_size, sas, overlap, n_rows, n_cols, signal_threshold, pair_stride, frame0, halo, n_total
    )


def piv_ensemble_routed(
    imgs: torch.Tensor,
    dim_size,
    sas,
    overlap,
    n_rows: int,
    n_cols: int,
    corr_min: float = 0.2,
    s2n_min: float = 3.0,
    signal_threshold: Optional[float] = None,
    frame0: int = 0,
    halo: Tuple[int, int] = (0, 0),
    n_total: Optional[int] = None,
):
    """Ensemble PIV by plan: :func:`piv_ensemble_fused` where :func:`kernel_takes`
    the windows, else :func:`pyorc_tpu_torch.ops.piv.piv_ensemble_scan`,
    recorded as route ``"torch_ops"``."""
    if kernel_takes(sas):
        return piv_ensemble_fused(
            imgs, dim_size, sas, overlap, n_rows, n_cols, corr_min, s2n_min, signal_threshold, frame0=frame0,
            halo=halo, n_total=n_total,
        )
    return _ensemble_torch_ops(
        imgs, dim_size, sas, overlap, n_rows, n_cols, corr_min, s2n_min, signal_threshold, frame0, halo, n_total
    )


# The JAX package's engine names (the ``engine`` argument of ``pyorc_tpu.parallel``)
ENGINES = ("auto", "xla", "fused", "fused-interpret")


def _card_only(fn):
    """``fn`` for frames on a CUDA device; frames anywhere else raise (engine ``"fused"``)."""

    @functools.wraps(fn)
    def run(imgs, *args, **kwargs):
        if imgs.device.type != "cuda":
            raise RuntimeError(f'engine="fused" launches the CUDA kernel; the frames are on {imgs.device}')
        return fn(imgs, *args, **kwargs)

    return run


def _engine(engine: str, routed, fused, plain, ops, corr_method: str = "auto"):
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if corr_method != "auto":
        method = piv_ops._resolve_corr_method(corr_method)
        if engine in ("fused", "fused-interpret"):
            raise ValueError(
                f'engine={engine!r} names the CUDA kernel\'s contract, which has no corr_method; '
                f'corr_method={corr_method!r} binds on the plain route (engine "auto" or "xla")'
            )
        return functools.partial(ops, corr_method=method)
    if engine == "auto":
        return routed
    if engine == "xla":
        return ops
    if engine == "fused":
        return _card_only(fused)
    return plain


def _pairs_torch_ops(imgs, dim_size, sas, overlap, n_rows, n_cols, signal_threshold=None, pair_stride=1,
                     frame0=0, halo=(0, 0), n_total=None, corr_method="auto"):
    KERNEL_ROUTE["piv_pairs_fused"] = "torch_ops"
    imgs = _own(imgs, frame0, halo, n_total, pair_stride, "piv_pairs_routed")
    return piv_ops.piv_pairs_strips(
        imgs, dim_size, win._as2(sas), win._as2(overlap), n_rows, n_cols, signal_threshold, corr_method,
        pair_stride=pair_stride,
    )


def _ensemble_torch_ops(imgs, dim_size, sas, overlap, n_rows, n_cols, corr_min=0.2, s2n_min=3.0,
                        signal_threshold=None, frame0=0, halo=(0, 0), n_total=None, corr_method="auto"):
    KERNEL_ROUTE["piv_ensemble_fused"] = "torch_ops"
    imgs = _own(imgs, frame0, halo, n_total, 1, "piv_ensemble_routed")
    return piv_ops.piv_ensemble_scan(
        imgs, dim_size, win._as2(sas), win._as2(overlap), n_rows, n_cols, corr_min, s2n_min, signal_threshold,
        corr_method,
    )


def piv_pairs_engine(engine: str = "auto", corr_method: str = "auto"):
    """The per-pair function that one of the JAX package's ``engine`` names selects.

    ``"auto"``: :func:`piv_pairs_routed` (the CUDA kernel on the card for
    sides of 8-128 px, the plain tensor ops by plan otherwise; the plain
    version on a CPU tensor). ``"xla"``: the XLA pipeline's semantics,
    :func:`pyorc_tpu_torch.ops.piv.piv_pairs_strips` (route ``"torch_ops"``).
    ``"fused"``: :func:`piv_pairs_fused`, which raises for frames off the
    card. ``"fused-interpret"``: the kernel's plain version,
    :func:`piv_pairs_fused_plain`. Each takes the arguments of
    :func:`piv_pairs_fused`.

    A ``corr_method`` other than ``"auto"`` ("fft" or "matmul") binds where
    the JAX package's binds, on the plain route: with ``"auto"`` or
    ``"xla"`` every call runs the plain tensor ops in that formulation
    (route ``"torch_ops"``), as the JAX package moves an ensemble off its
    kernel for an explicit method; with ``"fused"`` or ``"fused-interpret"``
    it raises ValueError, since no path switches engine.
    """
    return _engine(engine, piv_pairs_routed, piv_pairs_fused, piv_pairs_fused_plain, _pairs_torch_ops, corr_method)


def piv_ensemble_engine(engine: str = "auto", corr_method: str = "auto"):
    """The ensemble function that ``engine`` and ``corr_method`` select, as :func:`piv_pairs_engine`:
    :func:`piv_ensemble_routed`, :func:`pyorc_tpu_torch.ops.piv.piv_ensemble_scan`,
    :func:`piv_ensemble_fused` (the card only) or :func:`piv_ensemble_fused_plain`."""
    return _engine(
        engine, piv_ensemble_routed, piv_ensemble_fused, piv_ensemble_fused_plain, _ensemble_torch_ops, corr_method
    )
