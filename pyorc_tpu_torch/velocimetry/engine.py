"""Streaming PIV over a frame stack: chunked host->device pipeline.

Port of :mod:`pyorc_tpu.velocimetry.engine` (reference
``pyorc/velocimetry/ffpiv.py:24-474``). Frames stream through the device in
memory-sized chunks with a one-frame overlap; each chunk runs the per-pair
PIV contract through :func:`pyorc_tpu_torch.ops.piv_kernels.piv_pairs_routed`,
with ``passes > 1`` multi-pass PIV with window deformation through
:func:`pyorc_tpu_torch.ops.multipass.piv_multipass` (the same kernel on each
pass) or, with ``ensemble_corr=True``, the ensemble contract through
:func:`pyorc_tpu_torch.ops.piv_kernels.piv_ensemble_routed` (the CUDA kernels
on the GPU for windows with sides of 8-128 px; larger windows go to the
plain tensor ops by plan, as in the JAX package), and a device out-of-memory
error splits the chunk in two.
It runs on one device; multi-device sharding is ROADMAP.md, queue A item 9.

As in the JAX package, the ensemble ``count_min`` filter compares pair
counts against ``count_min * n_pairs`` of the whole stack (the parameter's
documented meaning), not the reference's chunk-dependent count.
"""

from __future__ import annotations

import logging
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .. import ndx
from .._device import get_device, to_device, to_host
from ..api.video import LazyFrames
from ..ops import multipass
from ..ops import piv as piv_ops
from ..ops import piv_kernels
from ..ops import windows as win

__all__ = ["get_piv"]

log = logging.getLogger(__name__)


def _chunk_plan(n_frames, dim_size, window_size, overlap, search_area_size, chunksize, memory_factor):
    """Frames per chunk from the device-memory model. Reference ffpiv.py:118-139."""
    if chunksize is None:
        req = win.required_memory(n_frames, dim_size, window_size, overlap, search_area_size)
        avail = win.available_memory() / memory_factor
        chunks = int(req // avail) + 1
        chunksize = int(np.ceil(n_frames / chunks))
        if chunksize <= 5:
            warnings.warn(
                f"Memory availability is poor; chunk size automatically set to 5 (was {chunksize}).",
                stacklevel=2,
            )
            chunksize = 5
    if chunksize < 2:
        raise OverflowError("Chunk size must be at least 2 frames.")
    return int(chunksize)


def _concat_pairs(left, right):
    """Per-pair outputs of two consecutive chunks, joined along the pair axis."""
    return tuple(np.concatenate([a, b], axis=0) for a, b in zip(left, right))


def _run_chunk_oom_backoff(fn, chunk, merge=_concat_pairs, min_frames=3):
    """Run fn(chunk) with halving splits on device OOM.

    Mirrors the reference's shrinking-chunk retry (reference ffpiv.py:13-21):
    a ``torch.cuda.OutOfMemoryError`` retries the chunk as two halves sharing
    a one-frame overlap, recursively, and joins the halves' outputs with
    ``merge`` (by default: concatenated per-pair outputs).
    """
    try:
        return fn(chunk)
    except torch.cuda.OutOfMemoryError:
        if chunk.shape[0] <= min_frames:
            raise
        warnings.warn(
            f"Device OOM on a {chunk.shape[0]}-frame chunk; retrying as two halves.",
            stacklevel=2,
        )
        mid = chunk.shape[0] // 2
        left = _run_chunk_oom_backoff(fn, chunk[: mid + 1], merge, min_frames)
        right = _run_chunk_oom_backoff(fn, chunk[mid:], merge, min_frames)
        return merge(left, right)


def _iter_chunks(data, chunksize):
    """Yield (start_pair_index, frames) with one-frame overlap between chunks.

    ``data`` is an in-memory stack (numpy array or tensor; chunks are views)
    or a lazy video stack, whose chain streams its batches from a prefetch
    thread, on the device when the chain has ops.
    """
    if isinstance(data, LazyFrames):
        for start, batch in data.iter_batches(chunksize, overlap=1):
            if batch.shape[0] >= 2:
                yield start, batch
        return
    n = data.shape[0]
    start = 0
    while start < n - 1:
        end = min(start + chunksize, n)
        yield start, data[start:end]
        if end >= n:
            break
        start = end - 1


def get_piv(
    frames: ndx.DataArray,
    y: np.ndarray,
    x: np.ndarray,
    dt: ndx.DataArray,
    window_size: Tuple[int, int],
    overlap: Tuple[int, int],
    search_area_size: Tuple[int, int],
    res_y: float,
    res_x: float,
    chunksize: Optional[int] = None,
    memory_factor: float = 4,
    ensemble_corr: bool = False,
    corr_min: float = 0.2,
    s2n_min: float = 3.0,
    count_min: float = 0.2,
    signal_threshold: Optional[float] = None,
    passes: int = 1,
) -> ndx.Dataset:
    """Time-resolved or ensemble PIV over the frame stack -> Dataset(v_x, v_y, corr, s2n).

    ``ensemble_corr=True`` averages the gated correlation planes of all
    pairs (``corr_min``, ``s2n_min``) and returns one time step; cells with
    fewer than ``count_min * n_pairs`` ok pairs are NaN. ``passes > 1`` runs
    multi-pass PIV with symmetric window deformation, each earlier pass at
    twice the window of the next (:mod:`pyorc_tpu_torch.ops.multipass`); it
    cannot be combined with ``ensemble_corr``.
    """
    if ensemble_corr and passes > 1:
        raise ValueError("ensemble_corr=True cannot be combined with passes > 1.")
    dim_size = tuple(frames.shape[-2:])
    n_frames = frames.shape[0]
    sas = tuple(win._as2(search_area_size))
    ov = tuple(win._as2(overlap))
    n_rows, n_cols = len(y), len(x)
    chunksize = _chunk_plan(n_frames, dim_size, window_size, ov, sas, chunksize, memory_factor)
    if ensemble_corr:
        return _piv_ensemble(
            frames.data, frames["time"].values, y, x, dt, res_y, res_x, n_rows, n_cols, dim_size, sas, ov,
            chunksize, corr_min, s2n_min, count_min, signal_threshold, frames.attrs,
        )
    return _piv_timestep(
        frames.data, frames["time"].values, y, x, dt, res_y, res_x, n_rows, n_cols, dim_size, sas, ov,
        chunksize, signal_threshold, frames.attrs, passes,
    )


def _piv_timestep(
    data, time_all, y, x, dt, res_y, res_x, n_rows, n_cols, dim_size, sas, ov,
    chunksize, signal_threshold, attrs, passes=1,
):
    device = get_device()
    dt_vals = np.asarray(dt.values if hasattr(dt, "values") else dt, dtype=np.float64)
    n_pairs = data.shape[0] - 1

    def run_one(chunk):
        frames = to_device(chunk, device)
        if passes > 1:
            out = multipass.piv_multipass(
                frames, dim_size, sas, ov, n_rows, n_cols, passes=passes, signal_threshold=signal_threshold
            )
        else:
            out = piv_kernels.piv_pairs_routed(frames, dim_size, sas, ov, n_rows, n_cols, signal_threshold)
        return tuple(to_host(o) for o in out)

    us, vs, cms, s2ns = [], [], [], []
    done = 0
    for _start, chunk in _iter_chunks(data, chunksize):
        u, v, cmax, s2n = _run_chunk_oom_backoff(run_one, chunk)
        us.append(u)
        vs.append(v)
        cms.append(cmax)
        s2ns.append(s2n)
        done += chunk.shape[0] - 1
        log.info("PIV (per frame pair): %d/%d", done, n_pairs)
    u = np.concatenate(us, axis=0)
    v = np.concatenate(vs, axis=0)
    cmax = np.concatenate(cms, axis=0)
    s2n = np.concatenate(s2ns, axis=0)
    time = time_all[1:]
    u = (u * res_x / dt_vals[:, None, None]).astype(np.float32)
    v = (v * res_y / dt_vals[:, None, None]).astype(np.float32)
    return _assemble_ds(s2n, cmax, u, v, time, y, x, attrs)


def _merge_ensemble(left, right):
    """Ensemble outputs of two consecutive chunks: sums and counts add, per-pair stats join."""
    return (left[0] + right[0], left[1] + right[1], *_concat_pairs(left[2:], right[2:]))


def _piv_ensemble(
    data, time_all, y, x, dt, res_y, res_x, n_rows, n_cols, dim_size, sas, ov,
    chunksize, corr_min, s2n_min, count_min, signal_threshold, attrs,
):
    device = get_device()
    n_pairs_total = data.shape[0] - 1

    def run_one(chunk):
        cs, cc, cmax, s2n = piv_kernels.piv_ensemble_routed(
            to_device(chunk, device), dim_size, sas, ov, n_rows, n_cols, corr_min, s2n_min, signal_threshold
        )
        return cs, cc, to_host(cmax), to_host(s2n)

    # corr_sum and corr_count stay on the device across chunks
    corr_sum, corr_count = 0.0, 0.0
    cms, s2ns = [], []
    done = 0
    for _start, chunk in _iter_chunks(data, chunksize):
        cs, cc, cmax, s2n = _run_chunk_oom_backoff(run_one, chunk, _merge_ensemble)
        corr_sum = corr_sum + cs
        corr_count = corr_count + cc
        cms.append(cmax)
        s2ns.append(s2n)
        done += chunk.shape[0] - 1
        log.info("PIV (ensemble): %d/%d", done, n_pairs_total)
    corr_sum = to_host(corr_sum)
    corr_count = to_host(corr_count)
    cmax_all = np.concatenate(cms, axis=0)
    s2n_all = np.concatenate(s2ns, axis=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        low_count = corr_count < count_min * n_pairs_total
        corr_sum[low_count] = np.nan
        flat_low = low_count.reshape(n_rows, n_cols)
        cmax_all = np.where(flat_low[None], np.nan, cmax_all)
        corr_mean = corr_sum / np.maximum(corr_count, 1)[..., None, None]
        corr_mean[corr_count == 0] = np.nan
        # zeroed (rejected) planes must not drag the time stats down
        cmax_masked = np.where(cmax_all == 0.0, np.nan, cmax_all)
        s2n_masked = np.where(s2n_all == 0.0, np.nan, s2n_all)
        cmax_mean = np.nanmean(cmax_masked, axis=0).reshape(1, n_rows, n_cols)
        s2n_mean = np.nanmean(s2n_masked, axis=0).reshape(1, n_rows, n_cols)
    u, v = piv_ops.u_v_displacement(torch.as_tensor(corr_mean)[None], n_rows, n_cols)
    dt_av = float(np.asarray(dt.values if hasattr(dt, "values") else dt).mean())
    u = (u.numpy() * res_x / dt_av).astype(np.float32)
    v = (v.numpy() * res_y / dt_av).astype(np.float32)
    # NaN out low-count cells in displacements too
    u[0][flat_low] = np.nan
    v[0][flat_low] = np.nan
    return _assemble_ds(s2n_mean, cmax_mean, u, v, time_all[1:2], y, x, attrs)


def _assemble_ds(s2n, corr, u, v, time, y, x, attrs) -> ndx.Dataset:
    from .. import const

    ds = ndx.Dataset(
        {
            "s2n": (("time", "y", "x"), s2n.astype(np.float32), const.VARS_ATTRS["s2n"]),
            "corr": (("time", "y", "x"), corr.astype(np.float32), const.VARS_ATTRS["corr"]),
            "v_x": (("time", "y", "x"), u, const.VARS_ATTRS["v_x"]),
            "v_y": (("time", "y", "x"), v, const.VARS_ATTRS["v_y"]),
        },
        coords={"time": np.asarray(time), "y": np.asarray(y), "x": np.asarray(x)},
        attrs=dict(attrs),
    )
    return ds
