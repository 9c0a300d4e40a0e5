"""The plain reference of one video's chain: plain PyTorch and NumPy, from the same frames as the port.

It imports nothing of the port and works out again whatever the port derives: normalize's sampled mean and
per-frame rescale, the orthorectification of a nadir pinhole camera, the FFT
cross-correlation PIV (per pair, multipass with symmetric window deformation, or ensemble), the masks, the
cross-section's sampling, the discharge. It follows pyOpenRiverCam's definitions as the port documents them:

- normalize: the float32 mean of every ``round(n / samples)``-th frame is subtracted, each frame is
  rescaled by its own extrema to [0, 255] and truncated to uint8;
- project: each cell of the area of interest reads the frame pixel nearest to where the camera sees the
  cell's corner on the water plane;
- PIV: demeaned windows, circular cross-correlation by real FFT, normalized by ``n sigma_a sigma_b`` and
  clipped at 0; the peak's 3-point Gaussian fit; ``u`` +columns, ``v`` -rows; ``corr`` the plane's maximum,
  ``s2n`` maximum over mean;
- multipass: windows halved from ``2**(passes - 1)`` times the last, frames A and B sampled bilinearly at
  ``x -+ d / 2`` of the previous pass's field, which passes the normalized median test in between;
- ensemble: the planes of the pairs that pass ``corr >= 0.2`` and ``s2n >= 3`` averaged, cells with fewer
  than 20 % of the pairs left out;
- masks, cross-section and discharge: pyOpenRiverCam's ``minmax``, ``corr``, ``count``, ``window_mean``,
  ``get_transect`` (equidistant points, the median over a 3 x 2 window where more than half of it has
  data, quantiles over time), ``get_q`` (gaps interpolated, ``0.9 v depth``) and ``get_river_flow``.

``precision`` is ``"float32"`` (the configuration's precision) or ``"bfloat16"``: every float32 value
rounded to bfloat16 where it is made, the control that a lower precision has to fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch

QUANTILES = (0.05, 0.25, 0.5, 0.75, 0.95)
ENS_CORR_MIN, ENS_S2N_MIN, ENS_COUNT_MIN = 0.2, 3.0, 0.2
MEDIAN_EPS, MEDIAN_THRESH = 0.1, 2.0
V_CORR = 0.9
CHUNK_PX = 1 << 27  # window pixels of one block of the correlation (its planes and spectra ~3 GB)
DEFORM_PAIRS = 8  # pairs deformed at a time (the dense fields and gathers of a block ~1 GB at 1080p)


def rounder(precision: str):
    """The function that rounds a float32 tensor to ``precision`` where it is made."""
    if precision == "float32":
        return lambda t: t
    if precision == "bfloat16":
        def rnd(t):
            if t.is_complex():
                return torch.view_as_complex(torch.view_as_real(t).to(torch.bfloat16).to(torch.float32).contiguous())
            return t.to(torch.bfloat16).to(t.dtype)
        return rnd
    raise ValueError(f"precision must be float32 or bfloat16, got {precision!r}")


# -- frames -------------------------------------------------------------------------------------------


def sampled_mean(frames: torch.Tensor, samples: int) -> np.ndarray:
    """normalize's mean image: the float32 mean of every ``round(n / samples)``-th frame, on the host."""
    step = round(frames.shape[0] / samples)
    return frames[::step].cpu().numpy().astype(np.float32).mean(axis=0).astype(np.float32)


def normalize(frames: torch.Tensor, mean: torch.Tensor, rnd) -> torch.Tensor:
    """uint8 frames: the mean subtracted, each frame rescaled by its extrema to [0, 255], truncated."""
    red = rnd(frames.to(torch.float32) - mean)
    lo = red.amin(dim=(-2, -1), keepdim=True)
    hi = red.amax(dim=(-2, -1), keepdim=True)
    return rnd(rnd(rnd(red - lo) / rnd(hi - lo)) * 255).to(torch.uint8)


def ortho_index(cfg: dict, f: float, inset):
    """(rows, cols): the frame pixel each cell of the ortho grid reads, for a nadir camera of focal length ``f``.

    The camera looks straight down from ``f * resolution`` m over the frame's centre (principal point at the
    centre, no distortion), so that a pixel is ``resolution`` m on the water plane, the image's rows
    pointing south. The grid covers the area of interest ``inset`` (rows, cols) px inside the frame's top and
    bottom, and left and right, edges at ``resolution`` m; each cell reads the pixel nearest to where its
    north-west corner is seen.
    """
    h, w, res = cfg["height"], cfg["width"], cfg["resolution"]
    a_r, a_c = inset
    cam_x, cam_y, cam_z = res * w / 2, res * h / 2, f * res
    ny, nx = h - 2 * a_r, w - 2 * a_c
    x = res * a_c + res * np.arange(nx)
    y = res * (h - a_r) - res * np.arange(ny)
    cols = w / 2 + f * (x - cam_x) / cam_z
    rows = h / 2 - f * (y - cam_y) / cam_z
    return np.round(rows).astype(np.int64), np.round(cols).astype(np.int64)


def project(frames: torch.Tensor, index) -> torch.Tensor:
    rows, cols = (torch.as_tensor(i, device=frames.device) for i in index)
    return frames.index_select(-2, rows).index_select(-1, cols)


# -- PIV ----------------------------------------------------------------------------------------------


def grid(n_px: int, ws: int, overlap: int):
    """Window starts and centres [px] along an axis of ``n_px`` pixels."""
    step = ws - overlap
    n = (n_px - ws) // step + 1
    starts = np.arange(n) * step
    return starts, starts + ws // 2


def _windows(frames: torch.Tensor, ws, ov) -> torch.Tensor:
    """[T, nr * nc, wy, wx] float32 windows of frames [T, H, W]."""
    (wy, wx), (oy, ox) = ws, ov
    r0, _ = grid(frames.shape[-2], wy, oy)
    c0, _ = grid(frames.shape[-1], wx, ox)
    out = frames.to(torch.float32).unfold(-2, wy, wy - oy).unfold(-2, wx, wx - ox)[:, : len(r0), : len(c0)]
    return out.reshape(frames.shape[0], len(r0) * len(c0), wy, wx)


def planes(wa: torch.Tensor, wb: torch.Tensor, rnd):
    """Normalized, clipped, centred correlation planes of window pairs, and which pairs have variance."""
    wy, wx = wa.shape[-2:]
    a = rnd(wa - wa.mean(dim=(-2, -1), keepdim=True))
    b = rnd(wb - wb.mean(dim=(-2, -1), keepdim=True))
    sa = rnd(torch.sqrt((a * a).mean(dim=(-2, -1))))
    sb = rnd(torch.sqrt((b * b).mean(dim=(-2, -1))))
    spec = rnd(torch.conj(rnd(torch.fft.rfft2(a))) * rnd(torch.fft.rfft2(b)))
    corr = torch.roll(rnd(torch.fft.irfft2(spec, s=(wy, wx))), shifts=(wy // 2, wx // 2), dims=(-2, -1))
    corr = rnd(corr / torch.clamp(rnd(wy * wx * sa * sb), min=1e-10)[..., None, None]).clamp(min=0.0)
    valid = (sa > 1e-6) & (sb > 1e-6)
    return torch.where(valid[..., None, None], corr, torch.zeros((), device=corr.device)), valid


def peak(corr: torch.Tensor):
    """(u, v) [px] of each plane's peak by the 3-point Gaussian fit, the first maximum in row-major order."""
    wy, wx = corr.shape[-2:]
    flat = torch.nan_to_num(corr.flatten(-2), nan=-math.inf)
    idx = flat.argmax(dim=-1)
    iy = (idx // wx).clamp(1, wy - 2)
    ix = (idx % wx).clamp(1, wx - 2)

    def at(dy, dx):
        v = torch.gather(flat, -1, ((iy + dy) * wx + ix + dx)[..., None])[..., 0]
        return torch.log(v.clamp(min=1e-10))

    c0, cl, cr, cu, cd = at(0, 0), at(0, -1), at(0, 1), at(-1, 0), at(1, 0)

    def fit(lo, hi):
        den = 2 * lo - 4 * c0 + 2 * hi
        den = torch.where(den.abs() < 1e-10, torch.full_like(den, -1e-10), den)
        return torch.nan_to_num((lo - hi) / den).clamp(-1.0, 1.0)

    col = ix.to(torch.float32) + fit(cl, cr)
    row = iy.to(torch.float32) + fit(cu, cd)
    return col - wx // 2, -(row - wy // 2)


def top2_gap(corr: torch.Tensor) -> torch.Tensor:
    """Each plane's largest value less its second: where it is small either peak may come first."""
    top = torch.topk(corr.flatten(-2), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def piv_pairs(fa: torch.Tensor, fb: torch.Tensor, ws, ov, rnd):
    """Per-pair PIV of frames ``fa[p]`` against ``fb[p]``: (u, v, corr, s2n, gap), each [P, nr, nc]."""
    nr = len(grid(fa.shape[-2], ws[0], ov[0])[0])
    nc = len(grid(fa.shape[-1], ws[1], ov[1])[0])
    per = max(1, CHUNK_PX // (nr * nc * ws[0] * ws[1]))
    outs = []
    for p0 in range(0, fa.shape[0], per):
        c, _ = planes(_windows(fa[p0 : p0 + per], ws, ov), _windows(fb[p0 : p0 + per], ws, ov), rnd)
        u, v = peak(c)
        cmax = c.flatten(-2).amax(dim=-1)
        outs.append((u, v, cmax, cmax / c.flatten(-2).mean(dim=-1), top2_gap(c)))
        del c
    return tuple(torch.cat(o).reshape(-1, nr, nc) for o in zip(*outs))


def bilinear(field: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``field`` [..., h, w] sampled bilinearly at (rows, cols), indices clamped to the edges (``rows`` and
    ``cols`` broadcast to [h', w'], or to [..., h', w'] for points of their own at each leading index)."""
    h, w = field.shape[-2:]
    lead = field.shape[:-2]
    out_shape = lead + torch.broadcast_shapes(rows.shape, cols.shape)[-2:]
    r0, c0 = torch.floor(rows), torch.floor(cols)
    wr, wc = rows - r0, cols - c0
    r0, c0 = r0.long(), c0.long()
    flat = field.reshape(lead + (h * w,))

    def take(r, c):
        idx = (r.clamp(0, h - 1) * w + c.clamp(0, w - 1)).expand(out_shape).reshape(lead + (-1,))
        return torch.gather(flat, -1, idx).view(out_shape)

    top = take(r0, c0) * (1 - wc) + take(r0, c0 + 1) * wc
    bot = take(r0 + 1, c0) * (1 - wc) + take(r0 + 1, c0 + 1) * wc
    return top * (1 - wr) + bot * wr


def _grid_pos(centres: np.ndarray, at, device) -> torch.Tensor:
    """Positions ``at`` [px] in the index space of the window centres, clipped to the grid."""
    step = float(centres[1] - centres[0]) if len(centres) > 1 else 1.0
    pos = (np.asarray(at, dtype=np.float64) - centres[0]) / step
    return torch.as_tensor(np.clip(pos, 0.0, len(centres) - 1.0), dtype=torch.float32, device=device)


def median_test(f: torch.Tensor) -> torch.Tensor:
    """The normalized median test over the 8 neighbours (edges repeated): outliers and NaNs get the median."""
    r, c = f.shape[-2:]
    ri = torch.arange(-1, r + 1, device=f.device).clamp(0, r - 1)
    ci = torch.arange(-1, c + 1, device=f.device).clamp(0, c - 1)
    fp = f.index_select(-2, ri).index_select(-1, ci)
    nb = torch.stack([fp[..., 1 + dy : 1 + dy + r, 1 + dx : 1 + dx + c] for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                      if (dy, dx) != (0, 0)], dim=-3)
    med = torch.nanquantile(nb, 0.5, dim=-3)
    resid = torch.nanquantile((nb - med.unsqueeze(-3)).abs(), 0.5, dim=-3)
    bad = ((f - med).abs() / (resid + MEDIAN_EPS) > MEDIAN_THRESH) | ~torch.isfinite(f)
    return torch.nan_to_num(torch.where(bad, med, f))


def piv_multipass(frames: torch.Tensor, ws: int, ov, passes: int, rnd):
    """Multipass PIV of consecutive pairs of uint8 ``frames`` [T, H, W]: (u, v, corr, s2n, gap) [T-1, nr, nc]."""
    h, w = frames.shape[-2:]
    f = frames.to(torch.float32)
    base_r = torch.arange(h, dtype=torch.float32, device=f.device)[:, None]
    base_c = torch.arange(w, dtype=torch.float32, device=f.device)[None, :]
    u = v = rows_prev = cols_prev = None
    for k in range(passes):
        size = ws * 2 ** (passes - 1 - k)
        size += size % 2
        last = k == passes - 1
        o = tuple(ov) if last else (size // 2, size // 2)
        rows_k, cols_k = grid(h, size, o[0])[1], grid(w, size, o[1])[1]
        if k == 0:
            du, dv, cmax, s2n, gap = piv_pairs(f[:-1], f[1:], (size, size), o, rnd)
            u_pred = v_pred = 0.0
        else:
            rr = _grid_pos(rows_prev, np.arange(h), f.device)[:, None]
            cc = _grid_pos(cols_prev, np.arange(w), f.device)[None, :]
            res = []
            for p0 in range(0, f.shape[0] - 1, DEFORM_PAIRS):
                p1 = min(p0 + DEFORM_PAIRS, f.shape[0] - 1)
                dr = rnd(bilinear(-v[p0:p1], rr, cc))
                dc = rnd(bilinear(u[p0:p1], rr, cc))
                a = rnd(bilinear(f[p0:p1], base_r - dr / 2, base_c - dc / 2))
                b = rnd(bilinear(f[p0 + 1 : p1 + 1], base_r + dr / 2, base_c + dc / 2))
                res.append(piv_pairs(a, b, (size, size), o, rnd))
                del dr, dc, a, b
            du, dv, cmax, s2n, gap = (torch.cat(x) for x in zip(*res))
            pr = _grid_pos(rows_prev, rows_k, f.device)[:, None]
            pc = _grid_pos(cols_prev, cols_k, f.device)[None, :]
            u_pred, v_pred = rnd(bilinear(u, pr, pc)), rnd(bilinear(v, pr, pc))
        u, v = rnd(u_pred + du), rnd(v_pred + dv)
        if not last:
            u, v = median_test(u), median_test(v)
        rows_prev, cols_prev = rows_k, cols_k
    return u, v, cmax, s2n, gap


def piv_ensemble(frames: torch.Tensor, ws: int, ov, rnd):
    """Ensemble PIV of all consecutive pairs of uint8 ``frames``: (u, v, corr, s2n, gap), each [1, nr, nc]."""
    h, w = frames.shape[-2:]
    nr, nc = len(grid(h, ws, ov[0])[0]), len(grid(w, ws, ov[1])[0])
    n_pairs = frames.shape[0] - 1
    total = torch.zeros((nr * nc, ws, ws), dtype=torch.float32, device=frames.device)
    count = torch.zeros(nr * nc, dtype=torch.float32, device=frames.device)
    cms, s2ns = [], []
    per = max(1, CHUNK_PX // (nr * nc * ws * ws))
    for p0 in range(0, n_pairs, per):
        win = _windows(frames[p0 : min(p0 + per, n_pairs) + 1], (ws, ws), ov)
        c, valid = planes(win[:-1], win[1:], rnd)
        cmax = c.flatten(-2).amax(dim=-1)
        s2n = rnd(cmax / c.flatten(-2).mean(dim=-1).clamp(min=1e-10))
        ok = (valid & (cmax >= ENS_CORR_MIN) & (s2n >= ENS_S2N_MIN)).to(torch.float32)
        for plane, o in zip(c * ok[..., None, None], ok):  # in pair order
            total = rnd(total + plane)
            count += o
        cms.append(cmax * ok)
        s2ns.append(s2n * ok)
        del c, win
    cmax = torch.cat(cms).reshape(n_pairs, nr, nc).cpu().numpy()
    s2n = torch.cat(s2ns).reshape(n_pairs, nr, nc).cpu().numpy()
    low = (count < ENS_COUNT_MIN * n_pairs).cpu().numpy()
    mean = total / count.clamp(min=1)[:, None, None]
    u, v = peak(mean)
    gap = top2_gap(mean)
    with np.errstate(invalid="ignore"):
        cm = np.nanmean(np.where(cmax == 0, np.nan, cmax), axis=0)
        sm = np.nanmean(np.where(s2n == 0, np.nan, s2n), axis=0)
    out = []
    for t in (u, v):
        t = t.cpu().numpy().copy()
        t[low] = np.nan
        out.append(t.reshape(1, nr, nc))
    cm = np.where(low.reshape(nr, nc), np.nan, cm)
    return out[0], out[1], cm[None], sm[None], gap.cpu().numpy().reshape(1, nr, nc)


# -- masks, cross-section, discharge --------------------------------------------------------------------


def _shifted(a: np.ndarray, sy: int, sx: int) -> np.ndarray:
    """``a`` [..., ny, nx] moved by (sy, sx) cells (cell (i, j) reads (i - sy, j - sx)), NaN where it leaves."""
    out = np.full(a.shape, np.nan, dtype=a.dtype)
    ny, nx = a.shape[-2:]
    out[..., max(sy, 0) : ny + min(sy, 0), max(sx, 0) : nx + min(sx, 0)] = \
        a[..., max(-sy, 0) : ny + min(-sy, 0), max(-sx, 0) : nx + min(-sx, 0)]
    return out


STRIDES = [(sy, sx) for sx in (-1, 0, 1) for sy in (-1, 0)]  # pyOpenRiverCam's 3 x 2 window (wdw=1)


def masks(field: dict, names) -> np.ndarray:
    """The cells every mask of ``names`` keeps, each computed on the unmasked field."""
    vx, vy = field["v_x"], field["v_y"]
    keep = np.ones(vx.shape, dtype=bool)
    with np.errstate(invalid="ignore", divide="ignore"):
        for name in names:
            if name == "minmax":
                s = (vx**2 + vy**2) ** 0.5
                keep &= (s > 0.1) & (s < 5.0)
            elif name == "corr":
                keep &= field["corr"] > 0.1
            elif name == "count":
                keep &= (np.isfinite(vx).sum(axis=0) > 0.33 * vx.shape[0])[None]
            elif name == "window_mean":
                mx = np.nanmean(np.stack([_shifted(vx, sy, sx) for sy, sx in STRIDES]), axis=0)
                my = np.nanmean(np.stack([_shifted(vy, sy, sx) for sy, sx in STRIDES]), axis=0)
                keep &= (np.abs(vx - mx) / mx < 0.7) | (np.abs(vy - my) / my < 0.7)
            else:
                raise ValueError(f"no reference for the mask {name!r}")
    return keep


def _extrapolating(s, values, at):
    """Linear interpolation of ``values`` over ascending ``s`` at ``at``, extended linearly past both ends."""
    out = np.interp(at, s, values)
    lo, hi = at < s[0], at > s[-1]
    out[lo] = values[0] + (at[lo] - s[0]) * (values[1] - values[0]) / (s[1] - s[0])
    out[hi] = values[-1] + (at[hi] - s[-1]) * (values[-1] - values[-2]) / (s[-1] - s[-2])
    return out


def transect(field: dict, cfg: dict, rows_px: np.ndarray, cols_px: np.ndarray, points, inset) -> dict:
    """The cross-section of a (masked) field [T, nr, nc] in m/s on the window centres (``rows_px``,
    ``cols_px`` of the projected frame, whose area of interest lies ``inset`` (rows, cols) px inside the
    frame's edges): per quantile and point ``v_eff`` [m/s], ``q`` [m2/s], and ``river_flow`` [m3/s] per
    quantile."""
    res, h = cfg["resolution"], cfg["height"]
    a_r, a_c = inset
    x, y, z = (np.asarray(p, dtype=np.float64) for p in points)
    dist = res * float(cols_px[1] - cols_px[0])
    d = np.concatenate([[0.0], np.hypot(np.diff(x), np.diff(y))])
    s = np.cumsum(d)
    s_at = np.arange(s.min(), np.ceil((1 + s.max() / dist) * dist), dist)
    x, y, z = (_extrapolating(s, c, s_at) for c in (x, y, z))
    # the points in the window grid's index space (world: x east, y north, the frame's rows south)
    fc = (x - res * (a_c + cols_px[0] + 0.5)) / dist
    fr = (res * (h - a_r - rows_px[0] - 0.5) - y) / dist
    nr, nc = len(rows_px), len(cols_px)
    valid = (fr >= 0) & (fr <= nr - 1) & (fc >= 0) & (fc <= nc - 1)
    fr, fc = np.where(valid, fr, 0.0), np.where(valid, fc, 0.0)
    r0 = np.clip(np.floor(fr).astype(int), 0, nr - 2)
    c0 = np.clip(np.floor(fc).astype(int), 0, nc - 2)
    wr, wc = fr - r0, fc - c0

    def effective(a, r, c):
        """The 3 x 2 window median at cells (r, c) of a [T, nr, nc], where more than half of it has data."""
        vals = []
        for sy, sx in STRIDES:
            rr, cc = r - sy, c - sx
            inside = (rr >= 0) & (rr < nr) & (cc >= 0) & (cc < nc)
            v = a[:, np.clip(rr, 0, nr - 1), np.clip(cc, 0, nc - 1)].copy()
            v[:, ~inside] = np.nan
            vals.append(v)
        vals = np.stack(vals)  # [stride, T, cells]
        with np.errstate(invalid="ignore"), np.testing.suppress_warnings() as sup:
            sup.filter(RuntimeWarning)
            enough = np.isfinite(np.nanmean(vals, axis=1)).sum(axis=0) > 0.5 * len(STRIDES)
            med = np.nanmedian(vals, axis=0)
        return np.where(enough[None], med, np.nan)

    def sample(a):
        out = np.zeros((a.shape[0], len(x)))
        for dr in (0, 1):
            for dc in (0, 1):
                wgt = (wr if dr else 1 - wr) * (wc if dc else 1 - wc)
                out += effective(a, np.minimum(r0 + dr, nr - 1), np.minimum(c0 + dc, nc - 1)).astype(np.float64) * wgt
        out[:, ~valid] = np.nan
        return out

    with np.errstate(invalid="ignore"), np.testing.suppress_warnings() as sup:
        sup.filter(RuntimeWarning)
        vx = np.nanquantile(sample(field["v_x"]), QUANTILES, axis=0)
        vy = np.nanquantile(sample(field["v_y"]), QUANTILES, axis=0)
    ang = np.zeros(len(x))
    ang[1:-1] = np.arctan2(x[2:] - x[:-2], y[2:] - y[:-2])
    ang[0] = np.arctan2(x[1] - x[0], y[1] - y[0])
    ang[-1] = np.arctan2(x[-1] - x[-2], y[-1] - y[-2])
    v_eff = np.cos(np.arctan2(vx, vy) - (ang - 0.5 * np.pi)[None]) * (vx**2 + vy**2) ** 0.5
    depth = np.maximum(0.0, z) - z
    v_eff[:, depth <= 0] = 0.0
    idx = np.arange(len(x), dtype=np.float64)
    for row in v_eff:
        good = np.isfinite(row)
        if good.sum() >= 2:
            row[~good] = np.interp(idx[~good], idx[good], row[good])
        elif good.sum() == 1:
            row[~good] = row[good][0]
    v_eff = np.where(depth[None] > 0, v_eff, 0.0)
    v_eff = np.nan_to_num(v_eff, nan=0.0)
    q = v_eff * V_CORR * depth[None]
    return {"v_eff": v_eff, "q": q, "river_flow": np.trapezoid(q, x=s_at, axis=1)}
