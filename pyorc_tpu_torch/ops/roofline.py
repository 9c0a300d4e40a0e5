"""The least time an H100 could take for the hand-written kernels' work, for ``chip_smoke.py``'s
timings; ``benchmark/roofline.py`` is the benchmark's frozen copy of these bounds.

A kernel's bound is the larger of two times: its operations (for the PIV
kernels those of the FFT algorithm, whatever implements it) over the card's
fp32 peak outside the tensor cores, and the bytes it must move (each input
read once, each output written once) over the card's memory rate. The peaks
are the H100 SXM's published ones at its full 700 W power limit; a card set
below it runs slower, so every bound stands beside the card's name and power
limit.
"""

from __future__ import annotations

import math

__all__ = [
    "PEAK_FP32_FLOPS", "DEFORM_PEAK_FLOPS", "INT32_PEAK_OPS", "PEAK_HBM_BYTES", "work_bound", "pairs_bound",
    "ensemble_bound", "deform_bound", "yuv420_bound",
]

# H100 SXM peaks: fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# float32 instructions of the deformation a pair pixel: four bilinear samples (the
# predictor's two at the pixel, then frame A's and frame B's) of 14 each (two
# floors, two weights and their complements, four weight products, then one
# product and three fused multiply-adds in the rounding order of JAX's compiled
# deformation), two halvings and four sample coordinates
DEFORM_OPS_PER_PIXEL = 4 * 14 + 2 + 4
# the rate of those instructions: PEAK_FP32_FLOPS counts a fused multiply-add as
# two operations, and the rounding order fixes which products fuse (the rest are
# rounded on their own), so each instruction, fused or not, is one of PEAK / 2
DEFORM_PEAK_FLOPS = PEAK_FP32_FLOPS / 2
# integer instructions of the YUV conversion (csrc/nv12.cu) a pixel, as its 16-byte path issues them
# on the two pixels of a row that share a chroma sample, held as the halves of a word: a pair takes two
# luma bytes (byte permutes), two multiply-adds (the offset folded in), one permute that keeps their
# high halves, and three DPX add-min-relus of two halves (4 a pixel); then gray a permute and four
# 16-by-8-bit dot products a pair and three quarters of a permute a pixel (three pack four levels),
# RGB six permutes every four pixels; and a quarter of a chroma sample's eleven (two bytes, four
# multiply-adds, a shift with a shifted sum, three permutes into halves)
YUV420_OPS_PER_PIXEL = {True: 4 + 2.5 + 0.75 + 11 / 4, False: 4 + 1.5 + 11 / 4}
# the multiply-adds issue on the FMA pipe and the rest on the ALU pipe, 64 a clock each on an SM of
# compute capability 9.0 (NVIDIA's CUDA C++ Programming Guide, arithmetic instruction throughput); a
# mix of both issues at most one warp instruction a clock on each of the SM's four schedulers, 128
# a clock: the fp32 fused multiply-add's rate, PEAK_FP32_FLOPS / 2
INT32_PEAK_OPS = PEAK_FP32_FLOPS / 2


def _ms(flops, n_bytes, peak_flops=PEAK_FP32_FLOPS):
    """(bound_ms, "operations" or "bytes") of work of ``flops`` operations at ``peak_flops`` moving ``n_bytes``."""
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def work_bound(frames, args, n_pairs, out_bytes, per_pair_extra=0):
    """The least time the card could take for a PIV kernel's work on these inputs.

    ``frames`` is the stack (a tensor: its elements and their size count as
    the bytes read), ``args`` are ``(dim_size, sas, overlap, n_rows, n_cols)``.
    Operations: per frame window one real 2-D FFT (2.5 N log2 N for N = wy wx
    points) plus the demean and variance (3 N); per window pair one inverse
    real FFT, the spectral product (3 N) and the plane's normalization, clip,
    max and sum (4 N), plus ``per_pair_extra`` N. Bytes: the frames read once
    and ``out_bytes`` written once. Returns (bound_ms, "operations" or "bytes").
    """
    _, sas, _, n_rows, n_cols = args
    n_pix = sas[0] * sas[1]
    fft = 2.5 * n_pix * math.log2(n_pix)
    n_win = n_rows * n_cols
    flops = n_win * (frames.shape[0] * (fft + 3 * n_pix) + n_pairs * (fft + (7 + per_pair_extra) * n_pix))
    return _ms(flops, frames.numel() * frames.element_size() + out_bytes)


def pairs_bound(frames, args, pair_stride=1):
    """The per-pair kernel's bound: four float32 outputs a window pair."""
    n_pairs = frames.shape[0] - 1 if pair_stride == 1 else frames.shape[0] // pair_stride
    return work_bound(frames, args, n_pairs, 4 * 4 * n_pairs * args[3] * args[4])


def ensemble_bound(frames, args):
    """The ensemble kernel's bound: the plane sums and counts, and cmax and s2n a window pair;
    the gate and the sum count one operation a plane element."""
    n_pairs, n_win = frames.shape[0] - 1, args[3] * args[4]
    out_bytes = 4 * (n_win * args[1][0] * args[1][1] + n_win + 2 * n_pairs * n_win)
    return work_bound(frames, args, n_pairs, out_bytes, per_pair_extra=1)


def deform_bound(frames, u):
    """Multipass's deformation kernel: ``frames`` [T, H, W] float32 deformed by ``u``, ``v`` [T - 1,
    n_rows, n_cols] into the pairs [2 (T - 1), H, W]. Bytes: the frames, both predictors and the two
    coordinate vectors read once, the pairs written once; operations: DEFORM_OPS_PER_PIXEL
    instructions a pair pixel (DEFORM_PEAK_FLOPS). Returns (bound_ms, "operations" or "bytes")."""
    t, h, w = frames.shape
    n_pairs = t - 1
    n_bytes = 4 * (t * h * w + 2 * u.numel() + h + w + 2 * n_pairs * h * w)
    return _ms(DEFORM_OPS_PER_PIXEL * n_pairs * h * w, n_bytes, DEFORM_PEAK_FLOPS)


def yuv420_bound(n, h, w, gray):
    """The YUV conversion kernel (``csrc/nv12.cu``): ``n`` frames of ``h`` x ``w`` from 4:2:0 planes
    (1.5 B a pixel read once) to gray (1 B) or RGB (3 B) written once, at PEAK_HBM_BYTES; its integer
    instructions (YUV420_OPS_PER_PIXEL, 10 gray and 8.25 RGB, at INT32_PEAK_OPS) take 40 % (gray) and
    18 % (RGB) of that time, so the bytes set the bound: 0.0464 ms gray and 0.0836 ms RGB for the lazy
    chain's batch of 30 frames of 1080p. Returns (bound_ms, "operations" or "bytes")."""
    pixels = n * h * w
    return _ms(YUV420_OPS_PER_PIXEL[bool(gray)] * pixels, pixels * (1.5 + (1 if gray else 3)), INT32_PEAK_OPS)
