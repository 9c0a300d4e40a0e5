"""Multi-pass adaptive PIV with symmetric window deformation (WIDIM).

Port of :mod:`pyorc_tpu.ops.multipass`, on its kernel route
(``_piv_multipass_fused``): coarse-to-fine interrogation where each pass
warps the frame pair by the previous pass's displacement field before
correlating. Central (symmetric) deformation -- frame A sampled at
``x - d/2`` and frame B at ``x + d/2`` -- cancels the first-order truncation
bias of single-pass PIV (the pull toward zero on uniform shifts) and keeps
correlation valid under shear. Between passes the Westerweel-Scarano
normalized median test replaces outliers and NaNs by their neighbourhood
median, so the predictor field stays smooth.

Each pass's correlation is :func:`pyorc_tpu_torch.ops.piv_kernels.piv_pairs_routed`
on the interleaved deformed pairs (a0, b0, a1, b1, ...) with
``pair_stride=2``: the CUDA kernel on the GPU for windows with sides of
8-128 px (every pass of ``window_size`` 32 or 25 with ``passes=3``), its
plain version on the CPU. A coarser pass (256 px for ``window_size`` 64 and
``passes=3``) goes by plan to the XLA-semantics pipeline
:func:`pyorc_tpu_torch.ops.piv.piv_pairs`, as the JAX package's kernel route
sends it to its XLA pipeline. The deformation, the median test and the
predictor's resampling are plain tensor ops in float32.

``map_coordinates(order=1, mode="nearest")`` of the JAX package is
:func:`pyorc_tpu_torch.ops.interp.map_linear`. ``jnp.nanmedian`` averages the two middle
values of an even count; ``torch.nanmedian`` returns the lower one, so the
median here is written out too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import piv_kernels
from . import windows as win
from .interp import map_linear

__all__ = ["piv_multipass", "multipass_window_sizes"]

# pixels of one block of pairs deformed at a time (bounds the gather's
# int64 index tensors to ~0.5 GB each)
_DEFORM_BLOCK_PX = 1 << 26


def multipass_window_sizes(window_size: Tuple[int, int], passes: int) -> list:
    """Coarse-to-fine window-size schedule ending at ``window_size``.

    Each earlier pass doubles the window (64 -> 32 -> 16 for passes=3,
    window_size=16), rounded to even.
    """
    ws = []
    for k in range(passes):
        f = 2 ** (passes - 1 - k)
        ws.append(tuple(win.round_to_even((window_size[0] * f, window_size[1] * f))))
    return ws


def _neighbor_stack(f: torch.Tensor) -> torch.Tensor:
    """Stack the 8 edge-padded neighbours of each grid cell: [..., 8, R, C]."""
    r, c = f.shape[-2], f.shape[-1]
    rows = torch.arange(-1, r + 1, device=f.device).clamp(0, r - 1)
    cols = torch.arange(-1, c + 1, device=f.device).clamp(0, c - 1)
    fp = f.index_select(-2, rows).index_select(-1, cols)
    stacks = [
        fp[..., 1 + dy : 1 + dy + r, 1 + dx : 1 + dx + c]
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if (dy, dx) != (0, 0)
    ]
    return torch.stack(stacks, dim=-3)


def _nanmedian(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.nanmedian`` over ``dim``: the NaN-skipping median, with the two
    middle values of an even count weighted 0.5 each; NaN where all are NaN."""
    nan = torch.isnan(x)
    count = (~nan).sum(dim, keepdim=True).to(x.dtype)
    ordered = torch.sort(torch.where(nan, torch.inf, x), dim=dim).values
    q = 0.5 * (count - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1 - high_w
    low = torch.clamp(torch.minimum(low, count - 1), min=0).long()
    high = torch.clamp(torch.minimum(high, count - 1), min=0).long()
    med = torch.gather(ordered, dim, low) * low_w + torch.gather(ordered, dim, high) * high_w
    med = torch.where(count == 0, torch.nan, med)
    return med.squeeze(dim)


def _median_validate(u: torch.Tensor, v: torch.Tensor, eps: float = 0.1, thresh: float = 2.0):
    """Normalized median test (Westerweel & Scarano 2005); outliers and NaNs
    are replaced by the neighbourhood median so the predictor field stays
    smooth for the next deformation pass."""

    def fix(f):
        nbrs = _neighbor_stack(f)
        med = _nanmedian(nbrs, -3)
        resid = _nanmedian(torch.abs(nbrs - med.unsqueeze(-3)), -3)
        r = torch.abs(f - med) / (resid + eps)
        bad = (r > thresh) | ~torch.isfinite(f)
        return torch.nan_to_num(torch.where(bad, med, f))

    return fix(u), fix(v)


def _grid_coords(src: np.ndarray, dst, device) -> torch.Tensor:
    """Positions ``dst`` (pixels) in the index space of the window centres ``src``, clipped to it."""
    step = float(src[1] - src[0]) if len(src) > 1 else 1.0
    pos = (torch.as_tensor(dst, dtype=torch.float32, device=device) - float(src[0])) / step
    return torch.clamp(pos, 0.0, len(src) - 1.0)


def _grid_to_dense(field: torch.Tensor, rows: np.ndarray, cols: np.ndarray, h: int, w: int) -> torch.Tensor:
    """Bilinear interpolation of a window-grid field onto the pixel grid.

    field: [..., n_rows, n_cols] at window centres (rows, cols); edge cells
    extend to the frame border (clamped index space).
    """
    rr = _grid_coords(rows, np.arange(h), field.device)
    cc = _grid_coords(cols, np.arange(w), field.device)
    return map_linear(field, rr[:, None], cc[None, :])


def _grid_to_grid(field: torch.Tensor, src_rows, src_cols, dst_rows, dst_cols) -> torch.Tensor:
    """Resample a window-grid field onto a (finer) window grid, bilinear.

    The same interpolant as :func:`_grid_to_dense`, evaluated at the
    destination window centres, so the predictor added back to the residual
    is exactly the field the pair was deformed with at those points.
    """
    rr = _grid_coords(src_rows, np.asarray(dst_rows, dtype=np.float32), field.device)
    cc = _grid_coords(src_cols, np.asarray(dst_cols, dtype=np.float32), field.device)
    return map_linear(field, rr[:, None], cc[None, :])


def _deform_pair(img_a: torch.Tensor, img_b: torch.Tensor, dr: torch.Tensor, dc: torch.Tensor):
    """Symmetric deformation: A sampled at x - d/2, B at x + d/2 (bilinear).

    img_a, img_b, dr, dc: [..., h, w] float32 (dr rows down, dc columns right).
    """
    h, w = img_a.shape[-2], img_a.shape[-1]
    base_r = torch.arange(h, dtype=torch.float32, device=img_a.device)[:, None]
    base_c = torch.arange(w, dtype=torch.float32, device=img_a.device)[None, :]
    a_def = map_linear(img_a, base_r - dr / 2, base_c - dc / 2)
    b_def = map_linear(img_b, base_r + dr / 2, base_c + dc / 2)
    return a_def, b_def


def _deformed_pairs(a_stack, b_stack, u, v, rows_prev, cols_prev):
    """The pairs deformed by the predictor (u, v) on the window grid (rows_prev,
    cols_prev), interleaved (a0, b0, a1, b1, ...) into [2 * n_pairs, h, w].

    Works through blocks of pairs so the dense fields and the gather indices
    of one block stay near ``_DEFORM_BLOCK_PX`` pixels.
    """
    n_pairs, h, w = a_stack.shape
    out = torch.empty((n_pairs, 2, h, w), dtype=torch.float32, device=a_stack.device)
    block = max(1, _DEFORM_BLOCK_PX // (h * w))
    for p0 in range(0, n_pairs, block):
        sl = slice(p0, p0 + block)
        # dense per-pixel predictor (dr = -v rows-down, dc = u cols-right)
        dr = _grid_to_dense(-v[sl], rows_prev, cols_prev, h, w)
        dc = _grid_to_dense(u[sl], rows_prev, cols_prev, h, w)
        out[sl, 0], out[sl, 1] = _deform_pair(a_stack[sl], b_stack[sl], dr, dc)
    return out.view(2 * n_pairs, h, w)


def piv_multipass(
    imgs: torch.Tensor,
    dim_size: Tuple[int, int],
    window_size: Tuple[int, int],
    overlap: Tuple[int, int],
    n_rows: int,
    n_cols: int,
    passes: int = 2,
    signal_threshold: Optional[float] = None,
    engine: str = "auto",
):
    """Multi-pass PIV: frames [T, H, W] -> (u, v, corr_max, s2n), each [T-1, n_rows, n_cols].

    The schedule doubles the window for each earlier pass
    (:func:`multipass_window_sizes`); earlier passes run at 50 % overlap,
    the last at ``overlap``. ``corr_max`` and ``s2n`` are the last pass's.
    NaN ``u``/``v`` of the last pass (zero-variance or below-threshold
    windows) stay NaN.

    With ``signal_threshold`` the JAX package always runs its XLA cascade,
    whose NaN-filled planes give each below-threshold (or zero-variance)
    window the placeholder displacement of an all-NaN plane,
    ``(1 - wx // 2, wy // 2 - 1)``. The earlier passes here give those
    windows the same placeholder before the median test, so the predictor is
    the cascade's; the last pass keeps NaN where the cascade reports the
    placeholder (ROADMAP.md, queue C).

    ``engine`` picks each pass's correlation by the JAX package's names
    (:func:`pyorc_tpu_torch.ops.piv_kernels.piv_pairs_engine`): ``"auto"``
    is :func:`~pyorc_tpu_torch.ops.piv_kernels.piv_pairs_routed`.
    """
    correlate = piv_kernels.piv_pairs_engine(engine)
    dim_size = tuple(dim_size)
    h, w = dim_size
    schedule = multipass_window_sizes(tuple(win._as2(window_size)), passes)
    overlaps = [tuple(s // 2 for s in ws) for ws in schedule[:-1]] + [tuple(win._as2(overlap))]
    if win.get_field_shape(dim_size, schedule[-1], overlaps[-1]) != (n_rows, n_cols):
        raise ValueError(
            f"(n_rows, n_cols)={(n_rows, n_cols)} is not the last pass's grid of {schedule[-1]} px windows"
        )
    frames = imgs.to(torch.float32)
    a_stack, b_stack = frames[:-1], frames[1:]
    n_pairs = a_stack.shape[0]
    u = v = cmax = s2n = None
    rows_prev = cols_prev = None
    for k, (ws, ov) in enumerate(zip(schedule, overlaps)):
        cols_k, rows_k = win.get_rect_coordinates(dim_size, ws, ws, ov)
        nr_k, nc_k = len(rows_k), len(cols_k)
        if k == 0:
            pairs = torch.stack([a_stack, b_stack], dim=1).view(2 * n_pairs, h, w)
            u_pred = torch.zeros((n_pairs, nr_k, nc_k), dtype=torch.float32, device=frames.device)
            v_pred = torch.zeros_like(u_pred)
        else:
            pairs = _deformed_pairs(a_stack, b_stack, u, v, rows_prev, cols_prev)
            u_pred = _grid_to_grid(u, rows_prev, cols_prev, rows_k, cols_k)
            v_pred = _grid_to_grid(v, rows_prev, cols_prev, rows_k, cols_k)
        du, dv, cmax, s2n = correlate(pairs, dim_size, ws, ov, nr_k, nc_k, signal_threshold, pair_stride=2)
        del pairs
        last = k == len(schedule) - 1
        if signal_threshold is not None and not last:
            du = torch.nan_to_num(du, nan=float(1 - ws[1] // 2))
            dv = torch.nan_to_num(dv, nan=float(ws[0] // 2 - 1))
        u = u_pred + du
        v = v_pred + dv
        if not last:
            # keep the predictor smooth for the next deformation
            u, v = _median_validate(u, v)
        rows_prev, cols_prev = rows_k, cols_k
    return u, v, cmax, s2n
