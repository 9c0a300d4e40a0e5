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
and the route is recorded as ``"torch_ops"``.

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

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use into one
library under ``build/pyorc_tpu_torch/`` and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

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
LAUNCHES = {"piv_pairs": 0, "piv_ensemble": 0}

MIN_WINDOW = 8
MAX_WINDOW = 128

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
        ctypes.c_int, ctypes.c_int,  # n_pairs, pair_stride
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
        ctypes.c_int,  # n_frames
        ctypes.c_float, ctypes.c_float,  # corr_min, s2n_min
        ctypes.c_int, ctypes.c_float,  # has_threshold, signal_threshold
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # cos/sin tables of y, of x
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # corr_sum, count, cmax, s2n
        ctypes.c_void_p,  # cudaStream_t
    ]
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


def _launch(imgs, sas, steps, n_rows, n_cols, signal_threshold, pair_stride):
    imgs = _kernel_frames(imgs, sas, "piv_pairs_fused")
    t, h, w = imgs.shape
    n_pairs = t - 1 if pair_stride == 1 else t // pair_stride
    if n_pairs < 1 or n_pairs > 65535:
        raise ValueError(f"piv_pairs_fused: {n_pairs} pairs per launch; the kernel takes 1-65535")
    device = imgs.device
    outs = [torch.empty((n_pairs, n_rows, n_cols), dtype=torch.float32, device=device) for _ in range(4)]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _library().piv_pairs_launch(
            imgs.data_ptr(), int(imgs.dtype == torch.uint8), h, w, sas[0], sas[1], steps[0], steps[1],
            n_rows, n_cols, n_pairs, pair_stride,
            int(signal_threshold is not None), float(signal_threshold or 0.0),
            *_tables(sas, device), *(o.data_ptr() for o in outs), stream,
        )
    if err != 0:
        raise RuntimeError(f"piv_pairs_fused: CUDA kernel launch failed (cudaError {err})")
    LAUNCHES["piv_pairs"] += 1
    return tuple(outs)


def _launch_ensemble(imgs, sas, steps, n_rows, n_cols, corr_min, s2n_min, signal_threshold):
    imgs = _kernel_frames(imgs, sas, "piv_ensemble_fused")
    t, h, w = imgs.shape
    if t < 2:
        raise ValueError(f"piv_ensemble_fused: {t} frames per launch; the kernel needs at least 2")
    device = imgs.device
    corr_sum = torch.empty((n_rows * n_cols, sas[0], sas[1]), dtype=torch.float32, device=device)
    count = torch.empty((n_rows * n_cols,), dtype=torch.float32, device=device)
    cmax, s2n = (torch.empty((t - 1, n_rows, n_cols), dtype=torch.float32, device=device) for _ in range(2))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _library().piv_ensemble_launch(
            imgs.data_ptr(), int(imgs.dtype == torch.uint8), h, w, sas[0], sas[1], steps[0], steps[1],
            n_rows, n_cols, t, float(corr_min), float(s2n_min),
            int(signal_threshold is not None), float(signal_threshold or 0.0),
            *_tables(sas, device),
            corr_sum.data_ptr(), count.data_ptr(), cmax.data_ptr(), s2n.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"piv_ensemble_fused: CUDA kernel launch failed (cudaError {err})")
    LAUNCHES["piv_ensemble"] += 1
    return corr_sum, count, cmax, s2n


def piv_pairs_fused(
    imgs: torch.Tensor,
    dim_size,
    sas,
    overlap,
    n_rows: int,
    n_cols: int,
    signal_threshold: Optional[float] = None,
    pair_stride: int = 1,
):
    """Per-pair PIV: frames [T, H, W] -> (u, v, corr_max, s2n), each [n_pairs, n_rows, n_cols].

    A CUDA tensor launches the CUDA kernel; a geometry the kernel does not
    take raises. A CPU tensor runs :func:`piv_pairs_fused_plain`.
    """
    sas = win._as2(sas)
    overlap = win._as2(overlap)
    if pair_stride not in (1, 2):
        raise ValueError(f"pair_stride must be 1 or 2, got {pair_stride}")
    if tuple(imgs.shape[-2:]) != tuple(dim_size):
        raise ValueError(f"frames of shape {tuple(imgs.shape)} do not match dim_size {tuple(dim_size)}")
    steps = _grid_steps(dim_size, sas, overlap, n_rows, n_cols)
    if imgs.device.type == "cuda":
        out = _launch(imgs, sas, steps, n_rows, n_cols, signal_threshold, pair_stride)
        KERNEL_ROUTE["piv_pairs_fused"] = "cuda"
        return out
    if imgs.device.type != "cpu":
        raise ValueError(f"piv_pairs_fused: no kernel for device {imgs.device}")
    KERNEL_ROUTE["piv_pairs_fused"] = "plain_cpu"
    return piv_pairs_fused_plain(imgs, dim_size, sas, overlap, n_rows, n_cols, signal_threshold, pair_stride)


def piv_pairs_fused_plain(
    imgs: torch.Tensor,
    dim_size,
    sas,
    overlap,
    n_rows: int,
    n_cols: int,
    signal_threshold: Optional[float] = None,
    pair_stride: int = 1,
):
    """The kernel's contract in plain PyTorch (``torch.fft``), on any device.

    Built from :mod:`pyorc_tpu_torch.ops.piv` plus the two points where the
    Pallas kernels differ from the XLA pipeline: ``u``/``v`` are NaN where a
    window has zero variance, and ``s2n = max / max(mean, 1e-10)``.
    """
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
):
    """Ensemble PIV: frames [T, H, W] -> (corr_sum [n_windows, wy, wx],
    corr_count [n_windows], corr_max [T-1, n_rows, n_cols], s2n [T-1, n_rows, n_cols]).

    A CUDA tensor launches the CUDA kernel (one launch for the whole stack);
    a geometry the kernel does not take raises. A CPU tensor runs
    :func:`piv_ensemble_fused_plain`.
    """
    sas = win._as2(sas)
    overlap = win._as2(overlap)
    if tuple(imgs.shape[-2:]) != tuple(dim_size):
        raise ValueError(f"frames of shape {tuple(imgs.shape)} do not match dim_size {tuple(dim_size)}")
    steps = _grid_steps(dim_size, sas, overlap, n_rows, n_cols)
    if imgs.device.type == "cuda":
        out = _launch_ensemble(imgs, sas, steps, n_rows, n_cols, corr_min, s2n_min, signal_threshold)
        KERNEL_ROUTE["piv_ensemble_fused"] = "cuda"
        return out
    if imgs.device.type != "cpu":
        raise ValueError(f"piv_ensemble_fused: no kernel for device {imgs.device}")
    KERNEL_ROUTE["piv_ensemble_fused"] = "plain_cpu"
    return piv_ensemble_fused_plain(imgs, dim_size, sas, overlap, n_rows, n_cols, corr_min, s2n_min, signal_threshold)


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
):
    """The kernel's contract in plain PyTorch (``torch.fft``), on any device:
    :func:`pyorc_tpu_torch.ops.piv.piv_ensemble_scan`, with TF32 off on the card."""
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
):
    """Per-pair PIV by plan: :func:`piv_pairs_fused` where :func:`kernel_takes`
    the windows, else :func:`pyorc_tpu_torch.ops.piv.piv_pairs` (the XLA
    pipeline's semantics, as the JAX package routes such windows), recorded
    as route ``"torch_ops"``. Never a fallback: a kernel that fails raises."""
    if kernel_takes(sas):
        return piv_pairs_fused(imgs, dim_size, sas, overlap, n_rows, n_cols, signal_threshold, pair_stride=pair_stride)
    KERNEL_ROUTE["piv_pairs_fused"] = "torch_ops"
    return piv_ops.piv_pairs(
        imgs, dim_size, win._as2(sas), win._as2(overlap), n_rows, n_cols, signal_threshold, pair_stride
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
):
    """Ensemble PIV by plan: :func:`piv_ensemble_fused` where :func:`kernel_takes`
    the windows, else :func:`pyorc_tpu_torch.ops.piv.piv_ensemble_scan`,
    recorded as route ``"torch_ops"``."""
    if kernel_takes(sas):
        return piv_ensemble_fused(imgs, dim_size, sas, overlap, n_rows, n_cols, corr_min, s2n_min, signal_threshold)
    KERNEL_ROUTE["piv_ensemble_fused"] = "torch_ops"
    return piv_ops.piv_ensemble_scan(
        imgs, dim_size, win._as2(sas), win._as2(overlap), n_rows, n_cols, corr_min, s2n_min, signal_threshold
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


def _engine(engine: str, routed, fused, plain, ops):
    if engine == "auto":
        return routed
    if engine == "xla":
        return ops
    if engine == "fused":
        return _card_only(fused)
    if engine == "fused-interpret":
        return plain
    raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")


def _pairs_torch_ops(imgs, dim_size, sas, overlap, n_rows, n_cols, signal_threshold=None, pair_stride=1):
    KERNEL_ROUTE["piv_pairs_fused"] = "torch_ops"
    return piv_ops.piv_pairs(
        imgs, dim_size, win._as2(sas), win._as2(overlap), n_rows, n_cols, signal_threshold, pair_stride
    )


def _ensemble_torch_ops(imgs, dim_size, sas, overlap, n_rows, n_cols, corr_min=0.2, s2n_min=3.0,
                        signal_threshold=None):
    KERNEL_ROUTE["piv_ensemble_fused"] = "torch_ops"
    return piv_ops.piv_ensemble_scan(
        imgs, dim_size, win._as2(sas), win._as2(overlap), n_rows, n_cols, corr_min, s2n_min, signal_threshold
    )


def piv_pairs_engine(engine: str = "auto"):
    """The per-pair function that one of the JAX package's ``engine`` names selects.

    ``"auto"``: :func:`piv_pairs_routed` (the CUDA kernel on the card for
    sides of 8-128 px, the plain tensor ops by plan otherwise; the plain
    version on a CPU tensor). ``"xla"``: the XLA pipeline's semantics,
    :func:`pyorc_tpu_torch.ops.piv.piv_pairs` (route ``"torch_ops"``).
    ``"fused"``: :func:`piv_pairs_fused`, which raises for frames off the
    card. ``"fused-interpret"``: the kernel's plain version,
    :func:`piv_pairs_fused_plain`. Each takes the arguments of
    :func:`piv_pairs_fused`.
    """
    return _engine(engine, piv_pairs_routed, piv_pairs_fused, piv_pairs_fused_plain, _pairs_torch_ops)


def piv_ensemble_engine(engine: str = "auto"):
    """The ensemble function that ``engine`` selects, as :func:`piv_pairs_engine`:
    :func:`piv_ensemble_routed`, :func:`pyorc_tpu_torch.ops.piv.piv_ensemble_scan`,
    :func:`piv_ensemble_fused` (the card only) or :func:`piv_ensemble_fused_plain`."""
    return _engine(
        engine, piv_ensemble_routed, piv_ensemble_fused, piv_ensemble_fused_plain, _ensemble_torch_ops
    )
