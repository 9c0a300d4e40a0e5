"""Space-Time Image Velocimetry (STIV) as batched PyTorch ops.

Port of :mod:`pyorc_tpu.ops.stiv`. STIV measures the streamwise surface
velocity from the orientation of advected-texture streaks in a space-time
image (STI): pixels are sampled along a search line aligned with the flow,
stacked over time, and the dominant streak angle in the resulting
(time x space) image gives displacement per frame (Fujita et al. 2007 style
gradient-tensor STIV).

All search lines are sampled in one bilinear gather
(:func:`pyorc_tpu_torch.ops.interp.map_linear` over a [n_lines, L] point
set, the same points in every frame), gradients are central differences, and
the orientation comes from a closed-form 2x2 structure-tensor eigen-analysis
with no data-dependent control flow. Windowed averaging of the tensor gives a
velocity profile along each line. Everything is float32 in the JAX version's
order of operations; the gather reads the frames in their own dtype and
converts the sampled points (uint8 -> float32 is exact), so a uint8 stack is
never copied as float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .interp import map_linear

__all__ = ["build_sti", "sti_velocity", "stiv_lines"]


def stiv_lines(centers_xy: np.ndarray, angle: float, length: float, n_samples: int):
    """Sample coordinates for STIV search lines.

    Parameters
    ----------
    centers_xy : [n_lines, 2] array
        line centre points (x, y) in the projected-grid PIXEL frame
        (column, row).
    angle : float
        flow direction in radians, measured from the +x (column) axis toward
        +row (i.e. image convention, y down).
    length : float
        line length in pixels.
    n_samples : int
        samples per line.

    Returns
    -------
    (rows, cols) : [n_lines, n_samples] float32 pixel coordinates (numpy).
    """
    centers = np.asarray(centers_xy, dtype=np.float64)
    t = np.linspace(-length / 2.0, length / 2.0, n_samples)
    cols = centers[:, 0:1] + np.cos(angle) * t[None, :]
    rows = centers[:, 1:2] + np.sin(angle) * t[None, :]
    return rows.astype(np.float32), cols.astype(np.float32)


def build_sti(frames: torch.Tensor, rows, cols) -> torch.Tensor:
    """Space-time images: sample each line in every frame (bilinear).

    frames: [T, H, W] in any dtype; rows/cols: [n_lines, L] pixel
    coordinates (tensors or numpy arrays). Returns [n_lines, T, L] float32 on
    the frames' device.
    """
    rows = torch.as_tensor(rows, dtype=torch.float32, device=frames.device)
    cols = torch.as_tensor(cols, dtype=torch.float32, device=frames.device)
    if frames.dtype not in (torch.uint8, torch.float32):
        frames = frames.to(torch.float32)
    sti = map_linear(frames, rows, cols, order="fma_b")  # [T, n_lines, L]
    return sti.movedim(0, 1)


# XLA's CPU build rewrites a cumulative sum (a reduce_window over the whole axis) into blocks of this
# many elements
_SCAN_BLOCK = 16


def _cumsum_as_xla(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.cumsum`` along ``dim`` in float32 as XLA's CPU build sums it: each block of
    ``_SCAN_BLOCK`` elements left to right, the blocks' totals scanned the same way, and each
    block's exclusive prefix then added to its elements (``torch.cumsum`` accumulates a float32
    CPU tensor in float64, and a CUDA one in another order)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    n_blocks = -(-n // _SCAN_BLOCK)
    blocks = torch.nn.functional.pad(x, (0, n_blocks * _SCAN_BLOCK - n)).unflatten(-1, (n_blocks, _SCAN_BLOCK))
    sums = [blocks[..., 0]]
    for k in range(1, _SCAN_BLOCK):
        sums.append(sums[-1] + blocks[..., k])
    out = torch.stack(sums, dim=-1)
    if n_blocks > 1:
        before = _cumsum_as_xla(out[..., -1], -1)
        out = out + torch.nn.functional.pad(before[..., :-1], (1, 0)).unsqueeze(-1)
    return out.flatten(-2)[..., :n].movedim(-1, dim)


def _box_smooth_1d(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Box filter along one axis (edge padded): a cumulative sum, differenced.

    Rounded as the JAX package's jitted function (its callers are jitted):
    the cumulative sum in XLA's blocks (:func:`_cumsum_as_xla`), and the
    division by ``size`` a multiply by its float32 reciprocal, as XLA
    rewrites a division by a constant.
    """
    if size <= 1:
        return x
    lo = size // 2
    hi = size - 1 - lo
    n = x.shape[axis]
    first = x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1)
    xp = torch.cat([first.repeat_interleave(lo, dim=axis), x, last.repeat_interleave(hi, dim=axis)], dim=axis)
    c = _cumsum_as_xla(xp, axis)
    c = torch.cat([torch.zeros_like(first), c], dim=axis)
    return (c.narrow(axis, size, n) - c.narrow(axis, 0, n)) * float(np.float32(1.0) / np.float32(size))


def _sti_orientation(sti: torch.Tensor, window: int, valid: Optional[torch.Tensor] = None):
    """Structure-tensor streak slope m [samples/frame] and coherence.

    Callers must have removed the static background already (see
    :func:`sti_velocity`): subtracting the temporal mean AFTER de-shearing
    would delete the (now near-vertical) signal streaks themselves.

    ``valid`` ([n_lines, T, L] in {0,1}) weights the tensor averaging so
    positions the de-shear resampled from outside the line (edge-clamped,
    pure artifact) contribute nothing; where fewer than half the samples in
    an averaging region are genuine, m is NaN and coherence 0.
    """
    (gt,) = torch.gradient(sti, dim=-2)
    (gx,) = torch.gradient(sti, dim=-1)
    w = torch.ones_like(sti) if valid is None else valid
    jtt = gt * gt * w
    jxx = gx * gx * w
    jtx = gt * gx * w
    if window and window > 0:
        red = lambda a: _box_smooth_1d(a.mean(dim=-2), int(window), -1)
    else:
        red = lambda a: a.mean(dim=(-2, -1))
    frac = red(w)
    norm = frac.clamp(min=1e-6)
    jtt, jxx, jtx = red(jtt) / norm, red(jxx) / norm, red(jtx) / norm
    # streak angle: the large-eigenvalue direction of J is the gradient
    # normal; the streak is perpendicular. phi measured from the t axis.
    phi = 0.5 * torch.atan2(2.0 * jtx, jtt - jxx) + math.pi / 2
    m = torch.tan(phi)
    trace = jtt + jxx
    ok = (trace > 1e-12) & (frac >= 0.5)
    coherence = torch.where(
        ok, torch.sqrt((jtt - jxx) ** 2 + 4.0 * jtx**2) / trace.clamp(min=1e-12), 0.0
    )
    m = torch.where(ok, m, torch.nan)
    return m, coherence


def _shear_sti(sti: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resample each STI along x' = x + m * (t - (T-1)/2) (bilinear, edge clamp).

    With m equal to the true streak slope the sheared STI's streaks become
    vertical (slope 0), where the gradient-tensor estimator is unbiased.

    Also returns a {0,1} validity mask: positions whose source column fell
    outside the line are edge-clamped copies, not data, and must not feed
    the orientation tensor (they otherwise fabricate steep fake streaks at
    the line ends — the larger |m|, the wider the contaminated margin).
    """
    _, t_len, l_len = sti.shape
    rows = torch.arange(t_len, dtype=torch.float32, device=sti.device)[:, None]
    tt = rows - (t_len - 1) / 2.0
    xx = torch.arange(l_len, dtype=torch.float32, device=sti.device)[None, :]
    cols = xx + m[:, None, None] * tt  # [n_lines, T, L]
    out = map_linear(sti, rows, cols)
    valid = ((cols >= 0.0) & (cols <= l_len - 1.0)).to(torch.float32)
    return out, valid


def sti_velocity(
    sti: torch.Tensor, step_px: float, dt: float, window: int = 0, refine: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Velocity (px of the ORIGINAL image per second) from STI streak angles.

    The dominant texture orientation is the small-eigenvalue direction of the
    2x2 gradient structure tensor J = <∇I ∇Iᵀ>, ∇ = (∂t, ∂x); the streak
    slope m = dx/dt [samples/frame] converts to velocity as
    ``v = m * step_px / dt`` (step_px = line sample spacing in image pixels,
    dt = seconds per frame). Positive v points along the +line direction.

    Parameters
    ----------
    sti : [n_lines, T, L]
    step_px, dt : float
        sample spacing (px) and frame interval (s).
    window : int
        if > 0, tensor averaging uses a box of this many samples along the
        line (velocity PROFILE, output [n_lines, L]); if 0, the tensor is
        averaged over the whole STI (one velocity per line, output
        [n_lines]).
    refine : int
        shear-refinement iterations: the finite-difference gradient
        attenuates steep streaks (underestimating |v| beyond ~1.5
        samples/frame), so each iteration de-shears the STI by the current
        estimate and measures the residual slope near vertical, where the
        estimator is unbiased.

    Returns
    -------
    (velocity, coherence): coherence in [0, 1] is the anisotropy of the
    structure tensor — the STIV analogue of a signal-to-noise ratio.
    """
    # remove the static background (per-position temporal mean) ONCE, in the
    # original STI frame, so fixed texture doesn't bias the angle to zero;
    # de-sheared copies are resampled from this background-free image
    sti = sti.to(torch.float32)
    sti = sti - sti.mean(dim=-2, keepdim=True)
    m_total = torch.zeros(sti.shape[0], dtype=torch.float32, device=sti.device)
    cur, valid = sti, None
    for _ in range(max(int(refine), 0)):
        m_k, _ = _sti_orientation(cur, 0, valid)
        m_total = m_total + torch.nan_to_num(m_k)
        cur, valid = _shear_sti(sti, m_total)
    m_res, coherence = _sti_orientation(cur, int(window), valid)
    if window and window > 0:
        m = m_total[:, None] + m_res
    else:
        m = m_total + m_res
    # the JAX version divides the two scalars in float32
    scale = float(np.float32(step_px) / np.float32(dt))
    return m * scale, coherence
