"""Device-batched optical water-level scoring as PyTorch ops.

Port of :mod:`pyorc_tpu.ops.waterlevel`. Every candidate waterline gives two
polygons (the strips on either side of it); each polygon is rasterized in a
fixed-size crop of the frame, its pixels are histogrammed, and the two
histograms are compared on the host (histogram-union dissimilarity). The
frame is padded and uploaded once; each polygon's crop is sliced on the
device from its offset.

Point-in-polygon is the JAX package's even-odd ray cast at pixel centres in
float32, with its guard on horizontal edges: a pixel (px, py) is inside when
an odd number of valid edges straddle the row py and cross it right of px,
at ``xint = x1 + (py - y1) / (y2 - y1) * (x2 - x1)``. ``xint`` depends on
the row and the edge only, so it is computed once per (row, edge) instead of
once per (pixel, edge); each row's crossings are sorted, and a pixel's count
is the number of crossings greater than px (``torch.searchsorted``). The
comparisons are the same float32 comparisons, so the counts are the JAX
package's, without its [slots, pixels, edges] intermediates (the 1080p grid
search scores ~830 slots of 256x288 pixels and 400 edges: 24.5 G edge tests
as a dense cast).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .._device import get_device, to_device, to_host

__all__ = ["polygon_histogram_scores"]

# Device bytes one batch of polygon slots may take in temporaries; the slot
# count per batch follows from the crop and ring sizes (results do not
# depend on it: every count is an exact integer).
BATCH_BYTES = 256 << 20
# Peak temporaries per crop pixel: the float32 query row and the int32
# crossing counts of searchsorted, then the counts, the uint8 crop and its
# bin, the int32 bin index and a few bool masks.
PIXEL_BYTES = 16
# Per (row, edge): the float32 intersection terms, the sorted crossings and
# sort's int64 indices, and the bool straddle masks.
ROW_EDGE_BYTES = 48


def _slots_per_batch(hc: int, wc: int, v_pad: int) -> int:
    per_slot = hc * wc * PIXEL_BYTES + hc * v_pad * ROW_EDGE_BYTES
    return max(1, BATCH_BYTES // per_slot)


def _counts(img_pad, offsets, rings, valid_edges, img_lims, bin_size: int, n_bins: int, hc: int, wc: int):
    """Per-slot histogram counts [B, n_bins] and pixel totals [B] on the device.

    img_pad: uint8 [H + hc, W + wc]; offsets: int64 [B, 2] crop origins (x0,
    y0); rings: float32 [B, V, 2] in crop-local coordinates; valid_edges:
    bool [B, V]; img_lims: float32 [B, 2] crop-local (x, y) frame bounds.
    ``totals`` count every polygon pixel inside the frame, the host path's
    ``min_samples`` gate; ``counts`` leave out values above
    ``bin_size * n_bins``, as ``np.histogram`` does.
    """
    dev = img_pad.device
    b = rings.shape[0]
    py = torch.arange(hc, dtype=torch.float32, device=dev)[None, :, None]  # [1, hc, 1]
    px = torch.arange(wc, dtype=torch.float32, device=dev)
    x1, y1 = rings[:, None, :, 0], rings[:, None, :, 1]  # [B, 1, V]
    x2, y2 = torch.roll(x1, -1, dims=2), torch.roll(y1, -1, dims=2)
    straddle = (y1 > py) != (y2 > py)  # [B, hc, V]
    t = (py - y1) / torch.where(y2 == y1, torch.full_like(y1, 1e-12), y2 - y1)
    xint = x1 + t * (x2 - x1)
    live = straddle & valid_edges[:, None, :]
    xcross = torch.where(live, xint, torch.full_like(xint, -torch.inf)).sort(dim=2).values
    del straddle, t, xint, live
    v = xcross.shape[2]
    # crossings right of px are those not <= px (-inf sorts first and never
    # counts): v - le of them, odd exactly when le's parity differs from v's
    le = torch.searchsorted(
        xcross.reshape(b * hc, v), px.expand(b * hc, wc).contiguous(), right=True, out_int32=True
    ).reshape(b, hc, wc)
    inside = le.bitwise_and_(1) != (v & 1)
    del le
    inside &= (px < img_lims[:, None, None, 0]) & (py < img_lims[:, None, None, 1])
    rows = offsets[:, 1, None] + torch.arange(hc, device=dev)  # [B, hc]
    cols = offsets[:, 0, None] + torch.arange(wc, device=dev)  # [B, wc]
    crop = img_pad[rows[:, :, None], cols[:, None, :]]  # uint8 [B, hc, wc]
    take = inside & (crop <= bin_size * n_bins)
    # bin index of each slot's pixels, the slots' bins side by side; excluded
    # pixels go to one spare bin past the last slot's
    flat = torch.clamp_(crop // bin_size, max=n_bins - 1).to(torch.int32)
    del crop
    flat += n_bins * torch.arange(b, dtype=torch.int32, device=dev)[:, None, None]
    flat.masked_fill_(~take, b * n_bins)
    counts = torch.bincount(flat.reshape(-1), minlength=b * n_bins + 1)
    return counts[: b * n_bins].reshape(b, n_bins), inside.sum(dim=(1, 2))


def polygon_histogram_scores(
    img: np.ndarray,
    pols1: Sequence[np.ndarray],
    pols2: Sequence[np.ndarray],
    bin_size: int = 5,
    min_samples: int = 50,
) -> np.ndarray:
    """Histogram-union dissimilarity scores for N candidate polygon pairs.

    img: uint8 [H, W]. polsX[i]: [Vi, 2] exterior ring (camera x, y). Returns
    scores [N] with the semantics of the per-candidate host path
    (``CrossSection.get_histogram_score``): 2 - sum(max(d1, d2) * bin_width)
    over normalized densities, or 2.0 when either side has < min_samples
    pixels. Rasterization is the even-odd ray cast at pixel centres of the
    JAX package's scorer; boundary pixels can differ from cv2.fillPoly's
    (which paints outlines) by one pixel.
    """
    n = len(pols1)
    if len(pols2) != n:
        raise ValueError(f"pols1 and pols2 must have equal length ({n} != {len(pols2)})")
    h, w = img.shape[:2]
    bin_size = int(bin_size)
    n_bins = len(np.arange(0, 256, bin_size)) - 1

    rings = []
    for p in list(pols1) + list(pols2):
        r = np.asarray(p, dtype=np.float64)[:, :2]
        r = r[np.isfinite(r).all(axis=1)]
        r = np.round(r)  # the host path rasterizes integer vertices
        rings.append(r)

    boxes = []
    for r in rings:
        if len(r) < 3:
            boxes.append(None)
            continue
        x0 = int(np.clip(np.floor(r[:, 0].min()), 0, w - 1))
        x1 = int(np.clip(np.ceil(r[:, 0].max()), 0, w - 1))
        y0 = int(np.clip(np.floor(r[:, 1].min()), 0, h - 1))
        y1 = int(np.clip(np.ceil(r[:, 1].max()), 0, h - 1))
        boxes.append(None if (x1 <= x0 or y1 <= y0) else (x0, x1, y0, y1))

    live = [i for i, b in enumerate(boxes) if b is not None]
    scores = np.full(n, 2.0, np.float64)
    if not live:
        return scores
    # one crop window covering every live bbox, rounded up as the JAX package does
    hc = max(boxes[i][3] - boxes[i][2] + 2 for i in live) + 1
    wc = max(boxes[i][1] - boxes[i][0] + 2 for i in live) + 1
    hc = -(-hc // 32) * 32
    wc = -(-wc // 32) * 32
    v_pad = -(-max(len(rings[i]) for i in live) // 8) * 8
    offsets = np.zeros((len(live), 2), np.int64)
    ring_arr = np.zeros((len(live), v_pad, 2), np.float32)
    edge_valid = np.zeros((len(live), v_pad), bool)
    img_lims = np.zeros((len(live), 2), np.float32)
    for j, i in enumerate(live):
        x0, x1, y0, y1 = boxes[i]
        offsets[j] = (x0, y0)
        img_lims[j] = (min(x0 + wc, w) - x0, min(y0 + hc, h) - y0)
        r = rings[i]
        k = min(len(r), v_pad)
        ring_arr[j, :k] = r[:k] - [x0, y0]
        ring_arr[j, k:] = r[k - 1] - [x0, y0]
        edge_valid[j, :k] = True

    img_dev = to_device(np.pad(np.asarray(img, dtype=np.uint8), ((0, hc), (0, wc))))
    device = get_device()
    batch = _slots_per_batch(hc, wc, v_pad)
    counts, totals = [], []
    for g0 in range(0, len(live), batch):
        sl = slice(g0, g0 + batch)
        c, t = _counts(
            img_dev, to_device(offsets[sl], device), to_device(ring_arr[sl], device),
            to_device(edge_valid[sl], device), to_device(img_lims[sl], device), bin_size, n_bins, hc, wc,
        )
        counts.append(c)
        totals.append(t)
    counts = to_host(torch.cat(counts)).astype(np.float64)
    totals = to_host(torch.cat(totals)).astype(np.float64)

    # scatter (polygon-side) results back to candidate pairs
    c_all = np.zeros((2 * n, n_bins), np.float64)
    s_all = np.zeros(2 * n, np.float64)
    c_all[np.asarray(live)] = counts
    s_all[np.asarray(live)] = totals
    c1, c2 = c_all[:n], c_all[n:]
    s1, s2 = s_all[:n], s_all[n:]
    # density normalization over IN-RANGE pixels (np.histogram semantics);
    # the min_samples gate uses ALL polygon pixels like the host path
    n1 = c1.sum(axis=1)
    n2 = c2.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        d1 = np.where(n1[:, None] > 0, c1 / n1[:, None], 0.0)
        d2 = np.where(n2[:, None] > 0, c2 / n2[:, None], 0.0)
    union = np.maximum(d1, d2).sum(axis=1)
    return np.where((s1 < min_samples) | (s2 < min_samples), 2.0, 2.0 - union)
