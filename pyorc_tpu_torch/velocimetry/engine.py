"""Streaming PIV over a frame stack: chunked host->device pipeline.

Port of :mod:`pyorc_tpu.velocimetry.engine` (reference
``pyorc/velocimetry/ffpiv.py:24-474``). Frames stream through the device in
memory-sized chunks of ``chunksize - 1`` pairs, each with the kernels' halo
of frames around it (:class:`pyorc_tpu_torch.ops.piv_kernels.Span`), so a
pair's result does not depend on the chunk size or on an out-of-memory
split; each chunk runs the per-pair
PIV contract through :func:`pyorc_tpu_torch.ops.piv_kernels.piv_pairs_routed`,
with ``passes > 1`` multi-pass PIV with window deformation through
:func:`pyorc_tpu_torch.ops.multipass.piv_multipass` (the same kernel on each
pass) or, with ``ensemble_corr=True``, the ensemble contract through
:func:`pyorc_tpu_torch.ops.piv_kernels.piv_ensemble_routed` (the CUDA kernels
on the GPU for windows with sides of 8-128 px; larger windows go to the
plain tensor ops by plan, as in the JAX package), and a device out-of-memory
error splits the chunk in two.

Where :func:`pyorc_tpu_torch._device.local_devices` gives more than one
device (several cards, or ``PYORC_TPU_CPU_DEVICES`` CPU shards), each chunk
is sharded over them along the pair axis (:mod:`pyorc_tpu_torch.parallel`),
as the JAX package shards over its devices: multipass through
``piv_multipass_sharded``, a chunk with fewer pairs than devices through the
2-D (pairs, rows) mesh of ``piv_pairs_sharded_2d`` where ``_plan_mesh2d``
picks one and the window grid is uniform, other chunks through
``piv_pairs_sharded``, ensemble chunks through ``piv_ensemble_sharded``; an
automatic chunk size grows with the device count. One device runs the
chunk as it is, on :func:`~pyorc_tpu_torch._device.get_device`.

Every route takes the plan above (engine "auto" of
:mod:`pyorc_tpu_torch.parallel.piv`). Unlike the JAX package, the engine
reads no ``PYORC_TPU_ENGINE``: that variable steers the JAX package, and the
port's tests set it in the same process to do so; the other engines are the
``engine`` argument of the sharded functions. ``PYORC_TPU_PROFILE=<dir>``
wraps the PIV loop in ``torch.profiler`` and writes a Chrome trace into
``<dir>``.

As in the JAX package, the ensemble ``count_min`` filter compares pair
counts against ``count_min * n_pairs`` of the whole stack (the parameter's
documented meaning), not the reference's chunk-dependent count. The
ensemble's chunk results stay where the chunks left them (the card, or the
host for a sharded chunk), and its finish runs there: only the four fields
come down.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _device, _trace, ndx, parallel
from .._device import get_device, to_device, to_host
from ..api.video import LazyFrames
from ..ops import multipass
from ..ops import piv as piv_ops
from ..ops import piv_kernels
from ..ops import windows as win

__all__ = ["get_piv"]

log = logging.getLogger(__name__)


def _chunk_plan(n_frames, dim_size, window_size, overlap, search_area_size, chunksize, memory_factor):
    """``chunksize``: a chunk's ``chunksize - 1`` pairs, or ``chunksize`` frames of its own. Reference
    ffpiv.py:118-139.

    A chunk reaches the device with up to ``sum(HALO)`` frames more, its halo
    (:meth:`~pyorc_tpu_torch.ops.piv_kernels.Span.cut`). Where the
    device-memory model splits the stack, the automatic size leaves room for
    them, so the frames on the device stay within the model's size; a
    ``chunksize`` the caller gives counts the chunk's own frames.
    """
    if chunksize is None:
        req = win.required_memory(n_frames, dim_size, window_size, overlap, search_area_size)
        avail = win.available_memory() / memory_factor
        chunks = int(req // avail) + 1
        chunksize = int(np.ceil(n_frames / chunks))
        if chunks > 1:
            chunksize -= sum(piv_kernels.HALO)
        if chunksize <= 5:
            warnings.warn(
                f"Memory availability is poor; chunk size automatically set to 5 (was {chunksize}).",
                stacklevel=2,
            )
            chunksize = 5
    if chunksize < 2:
        raise OverflowError("Chunk size must be at least 2 frames.")
    return int(chunksize)


def _plan_mesh2d(n_pairs: int, n_rows: int, n_dev: int):
    """Pick a (pairs, rows) mesh split, or None for the 1-D pairs mesh.

    The pair axis is the natural shard dimension; only when a chunk has too
    few pairs to occupy every device does the window-grid row axis take the
    remainder (large rasters, short pair batches). Returns (dp, dr) with
    dp * dr == n_dev and dr > 1, or None. ``PYORC_TPU_MESH2D`` overrides:
    "0" disables, an integer forces dr; other values keep the automatic choice.
    """
    forced = os.environ.get("PYORC_TPU_MESH2D")
    if forced:
        try:
            dr = int(forced)
        except ValueError:
            dr = None  # non-integer values keep auto behavior
        if dr is not None:
            if dr > 1 and n_dev % dr == 0:
                return (n_dev // dr, dr)
            return None
    if n_pairs >= n_dev:
        return None
    # largest divisor of n_dev that the pair count can still fill
    dp = max(d for d in range(1, n_dev + 1) if n_dev % d == 0 and d <= max(n_pairs, 1))
    dr = n_dev // dp
    if dr <= 1 or n_rows < dr:
        return None
    return (dp, dr)


@contextlib.contextmanager
def _maybe_profile():
    """``torch.profiler`` around the PIV loop when ``PYORC_TPU_PROFILE=<dir>``: a
    Chrome trace (``piv_trace_<pid>_<ns>.json``, for Perfetto or chrome://tracing)
    is written into ``<dir>``. Counterpart of the JAX package's ``jax.profiler.trace``."""
    trace_dir = os.environ.get("PYORC_TPU_PROFILE")
    if not trace_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"piv_trace_{os.getpid()}_{time.time_ns()}.json"))


def _concat_pairs(left, right):
    """Per-pair outputs of two consecutive chunks, joined along the pair axis."""
    return tuple(np.concatenate([a, b], axis=0) for a, b in zip(left, right))


def _run_chunk_oom_backoff(fn, span, merge=_concat_pairs):
    """Run fn(span) with halving splits on device OOM.

    Mirrors the reference's shrinking-chunk retry (reference ffpiv.py:13-21):
    a ``torch.cuda.OutOfMemoryError`` retries the chunk's pairs as two halves,
    each with its halo (:meth:`Span.cut`), recursively, and joins the halves'
    outputs with ``merge`` (by default: concatenated per-pair outputs). Each
    chunk run adds one to the counter ``engine:chunks`` (:mod:`pyorc_tpu_torch._trace`),
    each half of a split too.
    """
    try:
        out = fn(span)
    except torch.cuda.OutOfMemoryError:
        if span.n_pairs < 2:
            raise
        warnings.warn(
            f"Device OOM on a {span.n_pairs}-pair chunk; retrying as two halves.",
            stacklevel=2,
        )
        mid = span.n_pairs // 2
        left = _run_chunk_oom_backoff(fn, span.cut(0, mid), merge)
        right = _run_chunk_oom_backoff(fn, span.cut(mid, span.n_pairs), merge)
        return merge(left, right)
    _trace.count("engine:chunks")
    return out


def _chunk_bounds(n_frames, chunksize):
    """(first, end) pairs of each chunk: ``chunksize - 1`` pairs a chunk (``chunksize`` frames)."""
    per = chunksize - 1
    return [(p, min(p + per, n_frames - 1)) for p in range(0, n_frames - 1, per)]


def _iter_chunks(data, chunksize):
    """Yield each chunk as a :class:`~pyorc_tpu_torch.ops.piv_kernels.Span`:
    its pairs' frames with the kernels' halo, and its first frame's index.
    Neighbouring chunks share their halo frames, so an in-memory stack goes
    up to the device with up to ``sum(HALO)`` frames a chunk twice.

    ``data`` is an in-memory stack (numpy array or tensor; chunks are views)
    or a lazy video stack, whose chain streams its batches from a prefetch
    thread, on the device when the chain has ops.
    """
    whole = piv_kernels.Span(data)
    spans = [whole.cut(a, b) for a, b in _chunk_bounds(data.shape[0], chunksize)]
    if not isinstance(data, LazyFrames):
        yield from spans
        return
    ranges = [(span.frame0, span.frame0 + span.frames.shape[0]) for span in spans]
    for span, (start, batch) in zip(spans, data.iter_ranges(ranges)):
        yield span._replace(frames=batch)


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
    auto_chunk = chunksize is None
    chunksize = _chunk_plan(n_frames, dim_size, window_size, ov, sas, chunksize, memory_factor)
    devices = _device.local_devices()
    if auto_chunk and len(devices) > 1:
        # the memory model is per device; a sharded chunk splits over the
        # mesh, so each device still gets a worthwhile pair batch
        chunksize = min(n_frames, chunksize * len(devices))
    with _maybe_profile():
        if ensemble_corr:
            return _piv_ensemble(
                frames.data, frames["time"].values, y, x, dt, res_y, res_x, n_rows, n_cols, dim_size, sas, ov,
                chunksize, corr_min, s2n_min, count_min, signal_threshold, frames.attrs, devices,
            )
        return _piv_timestep(
            frames.data, frames["time"].values, y, x, dt, res_y, res_x, n_rows, n_cols, dim_size, sas, ov,
            chunksize, signal_threshold, frames.attrs, passes, devices,
        )


def _piv_timestep(
    data, time_all, y, x, dt, res_y, res_x, n_rows, n_cols, dim_size, sas, ov,
    chunksize, signal_threshold, attrs, passes, devices,
):
    device = get_device()
    dt_vals = np.asarray(dt.values if hasattr(dt, "values") else dt, dtype=np.float64)
    n_pairs = data.shape[0] - 1

    def run_sharded(span):
        mesh = parallel.make_mesh(devices)
        if passes > 1:
            return parallel.piv_multipass_sharded(
                span.own(), sas, ov, sas, mesh=mesh, passes=passes, signal_threshold=signal_threshold
            )
        plan = _plan_mesh2d(span.n_pairs, n_rows, len(devices))
        # the 2-D mesh cuts row slabs on window boundaries: a uniform grid only
        if plan is not None and parallel.piv.row_step(dim_size, sas, ov) is not None:
            mesh2d = parallel.piv.Mesh(np.asarray(devices, dtype=object).reshape(plan), ("pairs", "rows"))
            return parallel.piv_pairs_sharded_2d(
                span.frames, sas, ov, sas, mesh=mesh2d, signal_threshold=signal_threshold, **span.place()
            )
        return parallel.piv_pairs_sharded(
            span.frames, sas, ov, sas, mesh=mesh, signal_threshold=signal_threshold, **span.place()
        )

    def run_one(span):
        if len(devices) > 1:
            return run_sharded(span)
        if passes > 1:
            # explicit pairs, one a block: no halo to carry
            out = multipass.piv_multipass(
                to_device(span.own(), device), dim_size, sas, ov, n_rows, n_cols, passes=passes,
                signal_threshold=signal_threshold,
            )
        else:
            out = piv_kernels.piv_pairs_routed(
                to_device(span.frames, device), dim_size, sas, ov, n_rows, n_cols, signal_threshold,
                **span.place(),
            )
        return tuple(to_host(o) for o in out)

    us, vs, cms, s2ns = [], [], [], []
    done = 0
    for span in _iter_chunks(data, chunksize):
        u, v, cmax, s2n = _run_chunk_oom_backoff(run_one, span)
        us.append(u)
        vs.append(v)
        cms.append(cmax)
        s2ns.append(s2n)
        done += span.n_pairs
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
    """Ensemble outputs of two consecutive chunks: sums and counts add, per-pair stats join on their device."""
    return (left[0] + right[0], left[1] + right[1], *(torch.cat([a, b]) for a, b in zip(left[2:], right[2:])))


def _pair_mean(stat: torch.Tensor) -> torch.Tensor:
    """``np.nanmean`` over the pair axis with zeros taken as rejected planes: a float32 sum over a count, NaN
    where no pair counts."""
    keep = (stat != 0) & ~torch.isnan(stat)
    return torch.where(keep, stat, 0.0).sum(dim=0) / keep.sum(dim=0)


def _ensemble_finish(corr_sum, corr_count, cmax, s2n, count_min, n_pairs_total, n_rows, n_cols) -> torch.Tensor:
    """The ensemble's result from its sums and per-pair stats, on the device that holds them: (u, v) in px of the
    mean of the gated planes, and the pairs' corr and s2n means, stacked [4, n_rows, n_cols].

    As the JAX package's host finish: cells with fewer than ``count_min * n_pairs_total`` ok pairs are NaN in u, v
    and corr, and so is the mean plane of a cell that no pair counts.
    """
    low = corr_count < count_min * n_pairs_total
    corr_mean = torch.where(
        (low | (corr_count == 0))[:, None, None], torch.nan, corr_sum / corr_count.clamp(min=1)[:, None, None]
    )
    u, v = piv_ops.u_v_displacement(corr_mean[None], n_rows, n_cols)
    gated = torch.where(low.reshape(n_rows, n_cols), torch.nan, torch.stack([u[0], v[0], _pair_mean(cmax)]))
    return torch.cat([gated, _pair_mean(s2n)[None]])


def _piv_ensemble(
    data, time_all, y, x, dt, res_y, res_x, n_rows, n_cols, dim_size, sas, ov,
    chunksize, corr_min, s2n_min, count_min, signal_threshold, attrs, devices,
):
    device = get_device()
    n_pairs_total = data.shape[0] - 1

    def run_one(span):
        if len(devices) > 1:
            # host arrays: the finish runs on the CPU
            return tuple(torch.as_tensor(o) for o in parallel.piv_ensemble_sharded(
                span.frames, sas, ov, sas, mesh=parallel.make_mesh(devices), corr_min=corr_min, s2n_min=s2n_min,
                signal_threshold=signal_threshold, **span.place(),
            ))
        return piv_kernels.piv_ensemble_routed(
            to_device(span.frames, device), dim_size, sas, ov, n_rows, n_cols, corr_min, s2n_min, signal_threshold,
            **span.place(),
        )

    # every output stays where the chunks left it; only the fields come down
    corr_sum, corr_count = 0.0, 0.0
    cms, s2ns = [], []
    done = 0
    for span in _iter_chunks(data, chunksize):
        cs, cc, cmax, s2n = _run_chunk_oom_backoff(run_one, span, _merge_ensemble)
        corr_sum = corr_sum + cs
        corr_count = corr_count + cc
        cms.append(cmax)
        s2ns.append(s2n)
        done += span.n_pairs
        log.info("PIV (ensemble): %d/%d", done, n_pairs_total)
    if corr_sum.is_cuda:
        # the chunks' queued kernels drain here, so that the span holds the finish alone
        torch.cuda.current_stream(corr_sum.device).synchronize()
    with _trace.span("engine:ensemble_finish"):
        # the pairs' stats joined whole, so their means do not depend on the chunk plan
        fields = _ensemble_finish(
            corr_sum, corr_count, torch.cat(cms), torch.cat(s2ns), count_min, n_pairs_total, n_rows, n_cols
        )
        u, v, cmax_mean, s2n_mean = to_host(fields)[:, None]
    dt_av = float(np.asarray(dt.values if hasattr(dt, "values") else dt).mean())
    u = (u * res_x / dt_av).astype(np.float32)
    v = (v * res_y / dt_av).astype(np.float32)
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
