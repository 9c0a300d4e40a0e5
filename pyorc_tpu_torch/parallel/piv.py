"""Sharded PIV: frame pairs spread over a mesh of devices (port of :mod:`pyorc_tpu.parallel.piv`).

Frame pairs are independent; consecutive pairs share one frame, so each
shard takes its contiguous run of pairs plus a one-frame halo, cut from the
caller's stack (a slice of a tensor already on the shard's device is a view,
anything else is copied there once). Shards are dispatched from the
caller's thread one after another: the kernel launches are asynchronous, so
shards on different cards overlap without threads, and the results are
gathered only after every shard has been launched. Shards on one repeated
device (virtual shards of one card, or CPU shards) run one after another.

Nothing here is traced, so shards need not share one static shape: a run of
``n_pairs`` over ``n_dev`` devices gives ``ceil(n_pairs / n_dev)`` pairs a
shard, the last shards are shorter and a shard with no pair is skipped.
Per-pair PIV needs no reduction. Ensemble PIV adds the shards' ``corr_sum``
and ``corr_count`` in shard order on the mesh's first device (the JAX
package's ``psum`` over the pair axis): a fixed order, so the sum is
deterministic, and it equals the psum to float32 rounding. The counts are
exact: no pair is padded.

``engine`` takes the JAX package's four names
(:func:`pyorc_tpu_torch.ops.piv_kernels.piv_pairs_engine`):

- ``"auto"``: ``piv_pairs_routed`` / ``piv_ensemble_routed``, the CUDA
  kernel on the card for window sides of 8-128 px and the plain tensor ops
  by plan otherwise (the kernel's plain version on a CPU shard);
- ``"xla"``: the XLA pipeline's semantics in plain tensor ops (route
  ``"torch_ops"``);
- ``"fused"``: the CUDA kernel, which raises on a shard off the card;
- ``"fused-interpret"``: the kernel's plain version on any device.

A shard that fails raises; no path switches to another engine. The JAX
package's ``corr_method`` (its two formulations of the scan's planes) has no
counterpart: the port correlates through ``torch.fft`` only, so the sharded
functions do not take it. Results come back as host numpy arrays, as the JAX
package returns them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _device
from ..ops import multipass
from ..ops import piv as piv_ops
from ..ops import piv_kernels
from ..ops import windows as win

__all__ = [
    "Mesh",
    "make_mesh",
    "piv_pairs_sharded",
    "piv_ensemble_sharded",
    "piv_multipass_sharded",
    "piv_pairs_sharded_2d",
    "pad_pairs_for_devices",
    "pad_rows_for_devices",
]

class Mesh:
    """Devices laid out on named axes: ``("pairs",)`` or ``("pairs", "rows")``.

    ``devices`` is an object ndarray of ``torch.device`` with one dimension
    per axis name. A device may appear more than once: each appearance is a
    shard of its own (virtual shards of one card or of the CPU).
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        self.devices = np.empty(given.shape, dtype=object)
        for index, device in np.ndenumerate(given):
            self.devices[index] = torch.device(device)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {given.shape} needs {given.ndim} axis names, got {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]})"


def make_mesh(devices=None, axis: str = "pairs") -> Mesh:
    """A 1-D mesh over ``devices`` (default :func:`pyorc_tpu_torch._device.local_devices`)."""
    devices = _device.local_devices() if devices is None else list(devices)
    return Mesh(devices, (axis,))


def _pair_shards(n_pairs: int, n_dev: int) -> List[Tuple[int, int]]:
    """(first pair, end pair) of each shard that holds a pair: ``ceil(n_pairs / n_dev)`` pairs a shard."""
    per = -(-n_pairs // n_dev)
    return [(d * per, min((d + 1) * per, n_pairs)) for d in range(n_dev) if d * per < n_pairs]


def pad_pairs_for_devices(imgs: np.ndarray, n_dev: int, zero_pad: bool = False) -> Tuple[np.ndarray, int]:
    """Frames stacked into per-device overlapping slices [D, P+1, H, W] of one shape (the JAX package's layout).

    Pads the pair count to a multiple of ``n_dev`` by repeating the last
    frame (``zero_pad``: with zero frames). Returns the stack and the true
    pair count. The sharded functions here do not pad (see the module's
    docstring); this is the JAX package's helper, for callers that want its
    static layout.
    """
    imgs = np.asarray(imgs)
    n_pairs = imgs.shape[0] - 1
    per_dev = -(-n_pairs // n_dev)
    pad = per_dev * n_dev - n_pairs
    if pad > 0:
        tail = np.zeros_like(imgs[-1:]) if zero_pad else imgs[-1:]
        imgs = np.concatenate([imgs, np.repeat(tail, pad, axis=0)], axis=0)
    return np.stack([imgs[d * per_dev : d * per_dev + per_dev + 1] for d in range(n_dev)]), n_pairs


def _row_slab(frames, r0: int, h_slab: int):
    """Rows [r0, r0 + h_slab) of ``frames`` [..., H, W], zeros below the last row."""
    pad = r0 + h_slab - frames.shape[-2]
    slab = frames[..., r0 : r0 + h_slab, :]
    if pad <= 0:
        return slab
    shape = tuple(slab.shape[:-2]) + (pad, slab.shape[-1])
    if torch.is_tensor(slab):
        return torch.cat([slab, slab.new_zeros(shape)], dim=-2)
    return np.concatenate([slab, np.zeros(shape, slab.dtype)], axis=-2)


def _row_slab_layout(n_rows: int, n_dev_rows: int, wy: int, step_y: int) -> Tuple[int, int]:
    """(window rows a slab, slab height): slabs cut on window boundaries with a (wy - step_y)-row halo."""
    nb_per = -(-n_rows // n_dev_rows)
    return nb_per, (nb_per - 1) * step_y + wy


def pad_rows_for_devices(imgs, n_dev_rows: int, wy: int, step_y: int, n_rows: int) -> Tuple[np.ndarray, int]:
    """Frames cut into per-device row slabs [Dr, ..., H_slab, W] on window boundaries.

    Adjacent slabs overlap by ``wy - step_y`` rows (the halo, built from
    overlapping slices on the host); the window-row count is padded to a
    multiple of ``n_dev_rows`` with zero rows at the bottom, whose windows the
    caller drops. Returns the slabs and the window rows of each.
    """
    nb_per, h_slab = _row_slab_layout(n_rows, n_dev_rows, wy, step_y)
    imgs = np.asarray(imgs)
    return np.stack([_row_slab(imgs, d * nb_per * step_y, h_slab) for d in range(n_dev_rows)]), nb_per


def _geometry(imgs, window_size, overlap, search_area_size):
    sas = tuple(win._as2(window_size if search_area_size is None else search_area_size))
    ov = tuple(win._as2(overlap))
    dim_size = tuple(imgs.shape[-2:])
    return sas, ov, dim_size, *win.get_field_shape(dim_size, sas, ov)


def _gather(outs) -> Tuple[np.ndarray, ...]:
    """Per-shard output tuples -> each output on the host, shards joined along the pair axis."""
    return tuple(np.concatenate([_device.to_host(o) for o in column], axis=0) for column in zip(*outs))


def _run_pair_shards(imgs, devices, fn):
    """``fn(frames)`` on each shard's frames (its pairs plus a one-frame halo) on its device; joined."""
    shards = _pair_shards(imgs.shape[0] - 1, len(devices))
    outs = [fn(_device.to_device(imgs[p0 : p1 + 1], dev)) for (p0, p1), dev in zip(shards, devices)]
    return _gather(outs)


def piv_pairs_sharded(
    imgs,
    window_size: Tuple[int, int],
    overlap: Tuple[int, int],
    search_area_size: Optional[Tuple[int, int]] = None,
    mesh: Optional[Mesh] = None,
    signal_threshold: Optional[float] = None,
    engine: str = "auto",
):
    """Per-pair PIV over the mesh's pair axis.

    ``imgs`` [T, H, W] is a numpy array or a tensor. Returns
    (u, v, corr_max, s2n), each [T-1, n_rows, n_cols] (numpy).
    """
    mesh = mesh or make_mesh()
    sas, ov, dim_size, n_rows, n_cols = _geometry(imgs, window_size, overlap, search_area_size)
    correlate = piv_kernels.piv_pairs_engine(engine)
    return _run_pair_shards(
        imgs, list(mesh.devices.ravel()),
        lambda frames: correlate(frames, dim_size, sas, ov, n_rows, n_cols, signal_threshold),
    )


def piv_ensemble_sharded(
    imgs,
    window_size: Tuple[int, int],
    overlap: Tuple[int, int],
    search_area_size: Optional[Tuple[int, int]] = None,
    mesh: Optional[Mesh] = None,
    corr_min: float = 0.2,
    s2n_min: float = 3.0,
    signal_threshold: Optional[float] = None,
    engine: str = "auto",
):
    """Ensemble PIV over the mesh's pair axis; the shards' accumulators are added in shard order.

    Returns (corr_sum [n_windows, wy, wx], corr_count [n_windows],
    corr_max [T-1, n_rows, n_cols], s2n [T-1, n_rows, n_cols]) (numpy).
    """
    mesh = mesh or make_mesh()
    sas, ov, dim_size, n_rows, n_cols = _geometry(imgs, window_size, overlap, search_area_size)
    ensemble = piv_kernels.piv_ensemble_engine(engine)
    devices = list(mesh.devices.ravel())
    shards = _pair_shards(imgs.shape[0] - 1, len(devices))
    outs = [
        ensemble(_device.to_device(imgs[p0 : p1 + 1], dev), dim_size, sas, ov, n_rows, n_cols, corr_min, s2n_min,
                 signal_threshold)
        for (p0, p1), dev in zip(shards, devices)
    ]
    # the psum over the pair axis: the shards' accumulators added in shard
    # order on the first device
    corr_sum, corr_count = outs[0][0], outs[0][1]
    for cs, cc, _, _ in outs[1:]:
        corr_sum = corr_sum + cs.to(corr_sum.device)
        corr_count = corr_count + cc.to(corr_count.device)
    corr_max, s2n = _gather([out[2:] for out in outs])
    return _device.to_host(corr_sum), _device.to_host(corr_count), corr_max, s2n


def piv_multipass_sharded(
    imgs,
    window_size: Tuple[int, int],
    overlap: Tuple[int, int],
    search_area_size: Optional[Tuple[int, int]] = None,
    mesh: Optional[Mesh] = None,
    passes: int = 2,
    signal_threshold: Optional[float] = None,
    engine: str = "auto",
):
    """Multi-pass deformation PIV over the mesh's pair axis.

    Each pair's deformation depends only on its own displacement history, so
    the whole cascade (:func:`pyorc_tpu_torch.ops.multipass.piv_multipass`)
    runs per shard with no reduction; ``engine`` picks each pass's
    correlation. Returns (u, v, corr_max, s2n), each [T-1, n_rows, n_cols] (numpy).
    """
    mesh = mesh or make_mesh()
    sas, ov, dim_size, n_rows, n_cols = _geometry(imgs, window_size, overlap, search_area_size)
    return _run_pair_shards(
        imgs, list(mesh.devices.ravel()),
        lambda frames: multipass.piv_multipass(
            frames, dim_size, sas, ov, n_rows, n_cols, passes=passes, signal_threshold=signal_threshold,
            engine=engine,
        ),
    )


def row_step(dim_size, sas, overlap) -> Optional[int]:
    """The window grid's row step where the grid is uniform and the step divides the window, else None
    (the 2-D mesh cuts row slabs on window boundaries only then)."""
    row0, _ = win.get_window_starts(tuple(dim_size), sas, overlap)
    return piv_ops._strided_axis_starts(np.asarray(row0), sas[0])


def piv_pairs_sharded_2d(
    imgs,
    window_size: Tuple[int, int],
    overlap: Tuple[int, int],
    search_area_size: Optional[Tuple[int, int]] = None,
    mesh: Optional[Mesh] = None,
    signal_threshold: Optional[float] = None,
    engine: str = "auto",
):
    """Per-pair PIV over a 2-D ("pairs", "rows") mesh.

    For large frames and short pair batches the window grid's rows shard
    over the second axis: slabs are cut on window boundaries with a
    ``wy - step_y``-row halo (:func:`pad_rows_for_devices`), so each shard is
    independent and nothing is reduced. The default mesh pairs the local
    devices two by two on the row axis (one by one for an odd count). Raises
    ValueError for a window grid that is not uniform. Returns
    (u, v, corr_max, s2n), each [T-1, n_rows, n_cols] (numpy).
    """
    if mesh is None:
        devices = _device.local_devices()
        mesh = Mesh(np.asarray(devices, dtype=object).reshape(-1, 2 if len(devices) % 2 == 0 else 1),
                    ("pairs", "rows"))
    dp, dr = mesh.devices.shape
    sas, ov, dim_size, n_rows, n_cols = _geometry(imgs, window_size, overlap, search_area_size)
    step_y = row_step(dim_size, sas, ov)
    if step_y is None:
        raise ValueError("2-D sharding needs a uniform strided window grid")
    nb_per, h_slab = _row_slab_layout(n_rows, dr, sas[0], step_y)
    slab_dims = (h_slab, dim_size[1])
    correlate = piv_kernels.piv_pairs_engine(engine)
    shards = _pair_shards(imgs.shape[0] - 1, dp)
    launched = [
        [
            correlate(_device.to_device(_row_slab(imgs[p0 : p1 + 1], d * nb_per * step_y, h_slab), dev),
                      slab_dims, sas, ov, nb_per, n_cols, signal_threshold)
            for d, dev in enumerate(row_devices)
        ]
        for (p0, p1), row_devices in zip(shards, mesh.devices)
    ]
    # each pair shard's row slabs back together, the padded window rows dropped
    outs = [
        tuple(np.concatenate([_device.to_host(s[k]) for s in slabs], axis=1)[:, :n_rows] for k in range(4))
        for slabs in launched
    ]
    return tuple(np.concatenate(column, axis=0) for column in zip(*outs))
