"""Orthorectification: per-frame projective remap as PyTorch gathers.

Port of :mod:`pyorc_tpu.ops.ortho`. The index maps (world grid <-> image
pixels, computed once per video and water level) are built where the port
computes: on the CPU device by the host numpy copied from the JAX package
(``CameraConfig.map_idx_img_ortho`` / ``map_mean_idx_img_ortho``), on a card
by their float64 tensor twins (``*_tensor``), equal element for element;
either way they come back as host numpy. The remap of a frame batch is ONE
gather from a padded source ``[frame pixels | zero sentinel | group means]``
indexed by ``full_idx``; the means of oversampled cells are an
``index_add_`` group sum in float32, cast to the source dtype. Axis-aligned
maps take the separable slice/take fast paths.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import get_device, to_device, to_host

__all__ = [
    "OrthoMaps",
    "build_ortho_maps",
    "build_ortho_maps_tensor",
    "project_batch",
    "source_bbox",
    "crop_maps",
    "DeviceMaps",
    "device_maps",
]


class OrthoMaps(NamedTuple):
    """Static index maps for one (camera_config, water level) pair."""

    full_idx: np.ndarray  # [rows*cols] indices into [src (H*W) | zero | means]
    src_idx: Optional[np.ndarray]  # [n_mean] flat source indices for group-mean
    norm_idx: Optional[np.ndarray]  # [n_mean] group id per src sample
    counts: Optional[np.ndarray]  # [n_groups] static group sizes
    shape_in: Tuple[int, int]  # (H, W) of camera frames
    shape_out: Tuple[int, int]  # (rows, cols) of ortho grid
    # separable fast path (axis-aligned maps: near-nadir footage on a grid
    # aligned with the sensor): row index depends only on the output row and
    # column index only on the output column, every cell covered, no mean
    # groups. The remap then factors into two slice gathers (or pure strided
    # slices) instead of one element gather.
    row_idx: Optional[np.ndarray] = None  # [rows] source row per output row
    col_idx: Optional[np.ndarray] = None  # [cols] source col per output col


def build_ortho_maps(camera_config, x, y, z, reducer: str = "mean", device=None) -> OrthoMaps:
    """Precompute the index maps (once per video / water level) on ``device`` (default :func:`get_device`).

    On the CPU device the host numpy below runs (the plain version); on any
    other device :func:`build_ortho_maps_tensor` builds them there. A CUDA
    device without CUDA raises: the maps never fall back to the host.
    """
    device = get_device() if device is None else torch.device(device)
    if device.type != "cpu":
        return build_ortho_maps_tensor(camera_config, x, y, z, reducer, device)
    idx_img, idx_ortho = camera_config.map_idx_img_ortho(x, y, z)
    ortho_pos = np.where(idx_ortho)[0]
    h, w = camera_config.height, camera_config.width
    n_src = h * w
    # uncovered cells point at the zero sentinel appended after the frame
    full_idx = np.full(len(x) * len(y), n_src, np.int32)
    full_idx[np.asarray(ortho_pos)] = np.asarray(idx_img)
    if reducer == "mean":
        src_idx, uidx, norm_idx = camera_config.map_mean_idx_img_ortho(x, y, z)
    else:
        src_idx = uidx = norm_idx = None
    counts = None
    if src_idx is not None and len(np.asarray(uidx)):
        src_idx = np.asarray(src_idx, dtype=np.int32)
        norm_idx = np.asarray(norm_idx, dtype=np.int32)
        uidx = np.asarray(uidx, dtype=np.int64)
        counts = np.bincount(norm_idx, minlength=len(uidx)).astype(np.float32)
        # oversampled cells read their group's mean from the appended block
        full_idx[uidx] = n_src + 1 + np.arange(len(uidx), dtype=np.int64)
    else:
        src_idx = norm_idx = None
    ny, nx = len(y), len(x)
    row_idx = col_idx = None
    if src_idx is None and (full_idx != n_src).all():
        fi2 = full_idx.reshape(ny, nx)
        rr = fi2 // w
        cc = fi2 % w
        if (rr == rr[:, :1]).all() and (cc == cc[:1, :]).all():
            row_idx = np.ascontiguousarray(rr[:, 0], dtype=np.int32)
            col_idx = np.ascontiguousarray(cc[0, :], dtype=np.int32)
    return OrthoMaps(
        full_idx=full_idx,
        src_idx=src_idx,
        norm_idx=norm_idx,
        counts=counts,
        shape_in=(h, w),
        shape_out=(ny, nx),
        row_idx=row_idx,
        col_idx=col_idx,
    )


def build_ortho_maps_tensor(camera_config, x, y, z, reducer: str = "mean", device=None) -> OrthoMaps:
    """:func:`build_ortho_maps` as tensor ops on ``device``: the same :class:`OrthoMaps`, element for element.

    The projection and unprojection of every cell and source pixel, the
    group counts, the sentinel and mean-block entries of ``full_idx`` and the
    separable-path test all run on the device; the maps come down once, as
    the host path's dtypes. Runs on CPU tensors too (how the tests hold it to
    the host path).
    """
    device = get_device() if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"build_ortho_maps on {device}: torch.cuda.is_available() is False")
    idx_img, idx_ortho = camera_config.map_idx_img_ortho_tensor(x, y, z, device)
    h, w = camera_config.height, camera_config.width
    n_src = h * w
    ny, nx = len(y), len(x)
    full_idx = torch.full((ny * nx,), n_src, dtype=torch.int64, device=device)
    full_idx[idx_ortho] = idx_img
    src_idx = uidx = norm_idx = counts = None
    if reducer == "mean":
        src_idx, uidx, norm_idx = camera_config.map_mean_idx_img_ortho_tensor(x, y, z, device)
    if src_idx is not None and uidx.numel():
        counts = torch.bincount(norm_idx, minlength=uidx.numel()).to(torch.float32)
        full_idx[uidx] = n_src + 1 + torch.arange(uidx.numel(), dtype=torch.int64, device=device)
    else:
        src_idx = norm_idx = None
    row_idx = col_idx = None
    if src_idx is None and bool((full_idx != n_src).all()):
        fi2 = full_idx.reshape(ny, nx)
        rr = fi2 // w
        cc = fi2 % w
        if bool((rr == rr[:, :1]).all()) and bool((cc == cc[:1, :]).all()):
            row_idx, col_idx = rr[:, 0], cc[0, :]

    def down(a, dtype=torch.int32):
        return None if a is None else to_host(a.to(dtype))

    return OrthoMaps(
        full_idx=down(full_idx),
        src_idx=down(src_idx),
        norm_idx=down(norm_idx),
        counts=down(counts, torch.float32),
        shape_in=(h, w),
        shape_out=(ny, nx),
        row_idx=down(row_idx),
        col_idx=down(col_idx),
    )


def source_bbox(maps: OrthoMaps) -> Optional[Tuple[int, int, int, int]]:
    """Source-pixel bounding box ``(r0, r1, c0, c1)`` (half-open) actually
    read by the maps, or None when the maps read nothing.

    The ortho grid typically consumes a sub-rectangle of the camera frame
    (the AOI bbox re-projected into pixel space); everything outside it never
    influences the output, so callers can crop frames to this box *before*
    the host->device upload (see ``crop_maps``) and move proportionally fewer
    bytes per chunk.
    """
    h, w = maps.shape_in
    if maps.row_idx is not None:
        r0, r1 = int(maps.row_idx.min()), int(maps.row_idx.max()) + 1
        c0, c1 = int(maps.col_idx.min()), int(maps.col_idx.max()) + 1
        return (r0, r1, c0, c1)
    n_src = h * w
    used = maps.full_idx[maps.full_idx < n_src]
    if maps.src_idx is not None:
        used = np.concatenate([used, maps.src_idx])
    if len(used) == 0:
        return None
    rows = used // w
    cols = used % w
    return (int(rows.min()), int(rows.max()) + 1, int(cols.min()), int(cols.max()) + 1)


def crop_maps(maps: OrthoMaps, r0: int, c0: int, hc: int, wc: int) -> OrthoMaps:
    """Rebase the maps onto frames pre-cropped to ``[r0:r0+hc, c0:c0+wc]``.

    Every source index must fall inside the crop (use ``source_bbox`` to
    compute a covering box); results are bit-identical to projecting the
    uncropped frames with the original maps.
    """
    h, w = maps.shape_in
    n_src = h * w
    n_crop = hc * wc
    if maps.row_idx is not None:
        row_idx = (maps.row_idx - r0).astype(np.int32)
        col_idx = (maps.col_idx - c0).astype(np.int32)
        if row_idx.min() < 0 or row_idx.max() >= hc or col_idx.min() < 0 or col_idx.max() >= wc:
            raise ValueError("crop_maps: the crop does not cover every source index of the maps")
        fi2 = row_idx[:, None].astype(np.int64) * wc + col_idx[None, :]
        return maps._replace(
            full_idx=fi2.reshape(-1).astype(np.int32),
            shape_in=(hc, wc),
            row_idx=row_idx,
            col_idx=col_idx,
        )

    def rebase(idx):
        idx = np.asarray(idx, dtype=np.int64)
        rr = idx // w - r0
        cc = idx % w - c0
        if idx.size and (rr.min() < 0 or rr.max() >= hc or cc.min() < 0 or cc.max() >= wc):
            raise ValueError("crop_maps: the crop does not cover every source index of the maps")
        return rr * wc + cc

    full_idx = np.asarray(maps.full_idx, dtype=np.int64)
    src = full_idx < n_src
    out = np.empty_like(full_idx)
    out[src] = rebase(full_idx[src])
    # sentinel and mean-block entries shift with the new source size
    out[~src] = full_idx[~src] - n_src + n_crop
    src_idx = None if maps.src_idx is None else rebase(maps.src_idx).astype(np.int32)
    return maps._replace(
        full_idx=out.astype(np.int32), src_idx=src_idx, shape_in=(hc, wc)
    )


class DeviceMaps(NamedTuple):
    """The index maps of one :class:`OrthoMaps` as tensors on the device."""

    full_idx: torch.Tensor
    src_idx: Optional[torch.Tensor]
    norm_idx: Optional[torch.Tensor]
    counts: Optional[torch.Tensor]
    row_idx: Optional[torch.Tensor]
    col_idx: Optional[torch.Tensor]


def device_maps(maps: OrthoMaps, device) -> DeviceMaps:
    """Upload the index maps once; callers reuse the result for every chunk."""

    def up(a, dtype=torch.int64):
        return None if a is None else to_device(np.asarray(a), device, dtype)

    return DeviceMaps(
        full_idx=up(maps.full_idx),
        src_idx=up(maps.src_idx),
        norm_idx=up(maps.norm_idx),
        counts=up(maps.counts, torch.float32),
        row_idx=up(maps.row_idx),
        col_idx=up(maps.col_idx),
    )


def _arith_spec(idx: np.ndarray):
    """(start, limit, step) when ``idx`` is an arithmetic ramp, else None."""
    if len(idx) == 0:
        return None
    if len(idx) == 1:
        return (int(idx[0]), int(idx[0]) + 1, 1)
    step = int(idx[1]) - int(idx[0])
    if step > 0 and (np.diff(idx) == step).all():
        start = int(idx[0])
        return (start, start + step * (len(idx) - 1) + 1, step)
    return None


def project_batch(frames: torch.Tensor, maps: OrthoMaps, dmaps: Optional[DeviceMaps] = None) -> torch.Tensor:
    """Orthorectify a batch of frames [T, H, W] -> [T, rows, cols] on their device.

    Output dtype equals the input dtype (uint8 stays uint8 end to end);
    uncovered target cells are zero. ``dmaps`` are the maps already on the
    frames' device (:func:`device_maps`); they are uploaded when omitted.
    """
    if frames.dtype not in (torch.uint8, torch.float32):
        frames = frames.to(torch.float32)
    if maps.row_idx is not None:
        rspec = _arith_spec(maps.row_idx)
        cspec = _arith_spec(maps.col_idx)
        if rspec is not None and cspec is not None:
            return frames[:, rspec[0] : rspec[1] : rspec[2], cspec[0] : cspec[1] : cspec[2]]
    if dmaps is None:
        dmaps = device_maps(maps, frames.device)
    if maps.row_idx is not None:
        return frames.index_select(1, dmaps.row_idx).index_select(2, dmaps.col_idx)
    t = frames.shape[0]
    flat = frames.reshape(t, -1)
    parts = [flat, flat.new_zeros((t, 1))]
    if dmaps.src_idx is not None:
        samples = flat.index_select(1, dmaps.src_idx).to(torch.float32)
        sums = torch.zeros((t, dmaps.counts.shape[0]), dtype=torch.float32, device=flat.device)
        sums.index_add_(1, dmaps.norm_idx, samples)
        parts.append((sums / dmaps.counts[None, :]).to(flat.dtype))
    padded = torch.cat(parts, dim=1)
    return padded.index_select(1, dmaps.full_idx).reshape((t,) + tuple(maps.shape_out))
