"""FFT-based PIV cross-correlation, plain PyTorch (port of :mod:`pyorc_tpu.ops.piv`).

The per-pair pipeline of the JAX package on tensors:

  window gather -> demean -> rfft2 -> conjugate spectral multiply -> irfft2
  -> fftshift -> normalize to correlation coefficients -> stats (max, s2n)
  -> 3-point Gaussian subpixel peak -> (u, v) displacements

FP32 throughout (bf16 or TF32 correlation misses the 0.01 m/s velocity bar).
``piv_ensemble_scan`` accumulates the gated planes of all pairs instead
(the ensemble contract). These functions are the plain versions of the CUDA
kernels in
:mod:`pyorc_tpu_torch.ops.piv_kernels` and the reference the tests hold the
port against; the engine reaches them only through that module.

Semantics as in the JAX package: correlation planes are normalized to
Pearson-style coefficients (divide by n_pix * sigma_a * sigma_b) and
clipped at 0; ``u`` is +column displacement, ``v`` is -row displacement.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import windows as win

__all__ = [
    "extract_windows",
    "corr_stats",
    "u_v_displacement",
    "subpixel_peak",
    "piv_pairs",
    "piv_ensemble_scan",
]


def _strided_axis_starts(starts: np.ndarray, w: int):
    """The grid step if ``starts`` form an arithmetic grid whose step divides
    ``w`` (an int), else None."""
    if len(starts) < 2:
        return None
    step = int(starts[1] - starts[0])
    if step <= 0 or not np.all(np.diff(starts) == step):
        return None
    if w % step != 0:
        return None
    return step


def extract_windows(frames: torch.Tensor, row0: np.ndarray, col0: np.ndarray, wy: int, wx: int) -> torch.Tensor:
    """Gather interrogation windows: frames [..., H, W] -> [..., n_rows*n_cols, wy, wx].

    Uniform grids take ``Tensor.unfold`` views; any other grid gathers rows
    and columns with ``index_select``.
    """
    lead = tuple(frames.shape[:-2])
    row0 = np.asarray(row0)
    col0 = np.asarray(col0)
    n_rows, n_cols = len(row0), len(col0)
    step_y = int(row0[1] - row0[0]) if n_rows > 1 else 1
    step_x = int(col0[1] - col0[0]) if n_cols > 1 else 1
    uniform = (
        step_y > 0 and step_x > 0
        and np.all(np.diff(row0) == step_y) and np.all(np.diff(col0) == step_x)
    )
    if uniform:
        sub = frames[..., int(row0[0]) :, int(col0[0]) :]
        out = sub.unfold(-2, wy, step_y).unfold(-2, wx, step_x)[..., :n_rows, :n_cols, :, :]
    else:
        iy = torch.as_tensor((row0[:, None] + np.arange(wy)[None, :]).ravel(), device=frames.device)
        ix = torch.as_tensor((col0[:, None] + np.arange(wx)[None, :]).ravel(), device=frames.device)
        out = frames.index_select(-2, iy).index_select(-1, ix)
        out = out.reshape(lead + (n_rows, wy, n_cols, wx)).movedim(-2, -3)
    return out.reshape(lead + (n_rows * n_cols, wy, wx))


@functools.lru_cache(maxsize=16)
def _dft_mats(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag parts of the n-point DFT matrix, made in float64, stored float32."""
    k = np.arange(n, dtype=np.float64)
    ang = -2.0 * np.pi * k[:, None] * k[None, :] / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _normalized_corr_planes(win_a: torch.Tensor, win_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Circular normalized cross-correlation planes for window pairs.

    win_a, win_b: [..., wy, wx] float32. Returns (planes, valid): the
    fftshifted planes, same shape, and the window pairs whose two standard
    deviations both exceed 1e-6 (the others get all-zero planes).
    """
    wy, wx = win_a.shape[-2], win_a.shape[-1]
    n_pix = wy * wx
    a = win_a - win_a.mean(dim=(-2, -1), keepdim=True)
    b = win_b - win_b.mean(dim=(-2, -1), keepdim=True)
    sa = torch.sqrt((a * a).mean(dim=(-2, -1)))
    sb = torch.sqrt((b * b).mean(dim=(-2, -1)))
    fa = torch.fft.rfft2(a)
    fb = torch.fft.rfft2(b)
    corr = torch.fft.irfft2(torch.conj(fa) * fb, s=(wy, wx))
    corr = torch.fft.fftshift(corr, dim=(-2, -1))
    denom = torch.clamp(n_pix * sa * sb, min=1e-10)
    corr = corr / denom[..., None, None]
    # a demeaned circular-correlation plane sums to 0, so peak-to-mean s2n
    # is only meaningful on the non-negative plane
    corr = torch.clamp(corr, min=0.0)
    valid = (sa > 1e-6) & (sb > 1e-6)
    # zero-variance windows (uniform intensity) carry no signal
    return torch.where(valid[..., None, None], corr, torch.zeros((), dtype=corr.dtype, device=corr.device)), valid


def _pair_windows(imgs: torch.Tensor, dim_size, sas, overlap, pair_stride: int = 1):
    """Windows of both frames of every pair: (wa, wb), each [n_pairs, n_windows, wy, wx]."""
    row0, col0 = win.get_window_starts(dim_size, sas, overlap)
    w = extract_windows(imgs.to(torch.float32), row0, col0, sas[0], sas[1])
    if pair_stride == 1:
        return w[:-1], w[1:]
    n_pairs = w.shape[0] // pair_stride
    return w[0 : n_pairs * pair_stride : pair_stride], w[1 : n_pairs * pair_stride : pair_stride]


def cross_corr(
    imgs: torch.Tensor, dim_size, sas, overlap, signal_threshold: Optional[float] = None, pair_stride: int = 1
) -> torch.Tensor:
    """Correlation planes [n_pairs, n_windows, wy, wx] of the pairs at ``pair_stride``
    (all consecutive pairs at 1, interleaved explicit pairs at 2).

    Windows whose pair has a fraction of non-zero pixels below
    ``signal_threshold`` get NaN planes.
    """
    wa, wb = _pair_windows(imgs, dim_size, sas, overlap, pair_stride)
    corr, _ = _normalized_corr_planes(wa, wb)
    if signal_threshold is not None:
        ok = _pair_signal(wa, wb) >= signal_threshold
        corr = torch.where(ok[..., None, None], corr, torch.full((), float("nan"), device=corr.device))
    return corr


def top2_gap(imgs: torch.Tensor, dim_size, sas, overlap, pair_stride: int = 1) -> torch.Tensor:
    """Gap between the two largest values of each window pair's plane, [n_pairs, n_windows].

    The confidence measure parity checks condition on: where the gap is
    small, fp rounding may pick either of two near-equal peaks.
    """
    wa, wb = _pair_windows(imgs, dim_size, sas, overlap, pair_stride)
    corr, _ = _normalized_corr_planes(wa, wb)
    top2 = torch.topk(corr.flatten(-2), 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def _pair_signal(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """The smaller fraction of non-zero pixels of the two windows of each pair."""
    sig_a = (wa > 0).to(torch.float32).mean(dim=(-2, -1))
    sig_b = (wb > 0).to(torch.float32).mean(dim=(-2, -1))
    return torch.minimum(sig_a, sig_b)


def corr_stats(corr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(corr_max, s2n) per plane; s2n = max / mean, NaN-skipping (reference ffpiv.py:235-236)."""
    flat = corr.flatten(-2)
    corr_max = torch.where(torch.isnan(flat), -torch.inf, flat).amax(dim=-1)
    corr_max = torch.where(torch.isnan(flat).all(dim=-1), torch.nan, corr_max)
    corr_mean = torch.nanmean(flat, dim=-1)
    return corr_max, corr_max / corr_mean


def subpixel_peak(corr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Subpixel peak location per correlation plane via 3-point Gaussian fit.

    corr: [..., wy, wx]. Returns (row_peak, col_peak) measured from the
    top-left of the plane. Ties break on the first row-major index, as
    ``jnp.argmax`` does; the stencil is clamped one pixel inside the plane.
    """
    wy, wx = corr.shape[-2], corr.shape[-1]
    flat = corr.flatten(-2)
    flat = torch.where(torch.isnan(flat), -torch.inf, flat)
    idx = torch.argmax(flat, dim=-1)
    iy_c = torch.clamp(idx // wx, 1, wy - 2)
    ix_c = torch.clamp(idx % wx, 1, wx - 2)

    def take_at(dy, dx):
        lin = (iy_c + dy) * wx + (ix_c + dx)
        return torch.gather(flat, -1, lin[..., None])[..., 0]

    eps = 1e-10
    c0 = torch.clamp(take_at(0, 0), min=eps)
    cl = torch.clamp(take_at(0, -1), min=eps)
    cr = torch.clamp(take_at(0, 1), min=eps)
    cu = torch.clamp(take_at(-1, 0), min=eps)
    cd = torch.clamp(take_at(1, 0), min=eps)
    log0 = torch.log(c0)

    def safe_div(num, den):
        # the denominator is the (negative) log-curvature at the peak; keep
        # its sign and only guard against division by ~zero
        return num / torch.where(den.abs() < eps, torch.full_like(den, -eps), den)

    dx = safe_div(torch.log(cl) - torch.log(cr), 2 * torch.log(cl) - 4 * log0 + 2 * torch.log(cr))
    dy = safe_div(torch.log(cu) - torch.log(cd), 2 * torch.log(cu) - 4 * log0 + 2 * torch.log(cd))
    dx = torch.clamp(torch.nan_to_num(dx), -1.0, 1.0)
    dy = torch.clamp(torch.nan_to_num(dy), -1.0, 1.0)
    invalid = ~torch.isfinite(c0)
    row_peak = torch.where(invalid, torch.nan, iy_c.to(torch.float32) + dy)
    col_peak = torch.where(invalid, torch.nan, ix_c.to(torch.float32) + dx)
    return row_peak, col_peak


def u_v_displacement(corr: torch.Tensor, n_rows: int, n_cols: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Displacements (u, v) in pixels from planes [..., n_windows, wy, wx] -> [..., n_rows, n_cols].

    u = +column displacement, v = -row displacement (reference ffpiv.py:324,471).
    """
    wy, wx = corr.shape[-2], corr.shape[-1]
    row_peak, col_peak = subpixel_peak(corr)
    lead = tuple(corr.shape[:-3])
    u = (col_peak - wx // 2).reshape(lead + (n_rows, n_cols))
    v = (-(row_peak - wy // 2)).reshape(lead + (n_rows, n_cols))
    return u, v


def piv_pairs(imgs: torch.Tensor, dim_size, sas, overlap, n_rows, n_cols, signal_threshold=None, pair_stride=1):
    """Per-pair PIV with the JAX package's XLA semantics: frames [T, H, W] ->
    (u, v, corr_max, s2n), each [n_pairs, n_rows, n_cols]. ``pair_stride=2``
    correlates interleaved explicit pairs, the pairs the JAX package keeps
    (``[::2]``) when it sends multipass stacks to this pipeline."""
    corr = cross_corr(imgs, dim_size, sas, overlap, signal_threshold, pair_stride)
    corr_max, s2n = corr_stats(corr)
    u, v = u_v_displacement(corr, n_rows, n_cols)
    return u, v, corr_max.reshape(-1, n_rows, n_cols), s2n.reshape(-1, n_rows, n_cols)


# bytes of float32 window stacks and planes one step of piv_ensemble_scan may hold
_ENSEMBLE_STEP_BYTES = 1 << 30


def piv_ensemble_scan(
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
    """Ensemble PIV over all consecutive pairs (port of ``pyorc_tpu.ops.piv.piv_ensemble_scan``).

    Per pair, a window pair is ``ok`` when both windows have variance, its
    fraction of non-zero pixels reaches ``signal_threshold`` (if set), and
    its plane passes ``cmax >= corr_min`` and ``s2n >= s2n_min``; ok planes
    are added to ``corr_sum`` in pair order and counted. ``s2n`` is
    ``cmax / max(mean, 1e-10)``; it equals the scan's unguarded ratio
    wherever ``ok`` holds (an ok plane has mean >= cmax / n_pix). A Python
    loop takes the place of ``lax.scan``; each step takes as many pairs as
    keep its window stacks, spectra and planes near ``_ENSEMBLE_STEP_BYTES``,
    and the planes are added in pair order either way.

    Returns (corr_sum [n_windows, wy, wx], corr_count [n_windows],
    corr_max [T-1, n_rows, n_cols], s2n [T-1, n_rows, n_cols]), float32, with
    ``ok * cmax`` and ``ok * s2n`` per pair.
    """
    wy, wx = sas
    row0, col0 = win.get_window_starts(dim_size, sas, overlap)
    n_pairs = imgs.shape[0] - 1
    # windows of both frames, their spectra and the planes: ~8 copies of one frame's windows
    pairs_per_step = max(1, _ENSEMBLE_STEP_BYTES // (8 * len(row0) * len(col0) * wy * wx * 4))
    corr_sum = torch.zeros((len(row0) * len(col0), wy, wx), dtype=torch.float32, device=imgs.device)
    corr_count = torch.zeros(corr_sum.shape[0], dtype=torch.float32, device=imgs.device)
    cmaxs, s2ns = [], []
    for p0 in range(0, n_pairs, pairs_per_step):
        p1 = min(p0 + pairs_per_step, n_pairs)
        w = extract_windows(imgs[p0 : p1 + 1].to(torch.float32), row0, col0, wy, wx)
        wa, wb = w[:-1], w[1:]
        corr, valid = _normalized_corr_planes(wa, wb)
        flat = corr.flatten(-2)
        cmax = flat.amax(dim=-1)
        s2n = cmax / torch.clamp(flat.mean(dim=-1), min=1e-10)
        ok = valid & (cmax >= corr_min) & (s2n >= s2n_min)
        if signal_threshold is not None:
            ok &= _pair_signal(wa, wb) >= signal_threshold
        okf = ok.to(torch.float32)
        for plane, o in zip(corr * okf[..., None, None], okf):
            corr_sum += plane
            corr_count += o
        cmaxs.append(cmax * okf)
        s2ns.append(s2n * okf)
    shape = (n_pairs, n_rows, n_cols)
    return corr_sum, corr_count, torch.cat(cmaxs).reshape(shape), torch.cat(s2ns).reshape(shape)
