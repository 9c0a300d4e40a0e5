"""Frames accessor: preprocessing filters, orthorectification, PIV and STIV entry points.

Port of :mod:`pyorc_tpu.api.frames` (reference ``pyorc/api/frames.py``), gray
or RGB, for two kinds of frame stack:

- in memory (numpy): each op uploads the stack to the device (per-frame ops
  in batches), runs there as PyTorch ops (:mod:`pyorc_tpu_torch.ops.filters`,
  :mod:`pyorc_tpu_torch.ops.ortho`, :mod:`pyorc_tpu_torch.ops.stiv`), and
  returns host arrays. Where :func:`pyorc_tpu_torch._device.local_devices`
  gives more than one device and a batch's frame count is a multiple of
  their number, a per-frame op splits the batch over them along time and
  gathers the parts in order (the JAX package's ``_put_time_sharded``);
- lazy, from ``Video.get_frames`` (:class:`pyorc_tpu_torch.api.video.LazyFrames`):
  the per-frame ops (filters, ``project``) are appended to the stack's op
  chain and run per batch on the device after one upload of the decoded
  batch, so decode -> filters -> project streams into ``get_piv`` with no
  download. ``project`` crops each decoded batch on the host to the source
  box its maps read, when every op before it declares a stencil ``halo``.
  The ops over time (``range``, ``time_diff``, ``reduce_rolling``) and
  ``get_stiv`` read the chain's device batches.

The PIV loop, time-resolved, multipass or ensemble, streams through the CUDA
kernels (:mod:`pyorc_tpu_torch.velocimetry`).

The exports read a lazy stack as its chain is read, not frame by frame:
``to_video``, ``to_ani`` and ``to_geotiffs`` walk ``iter_batches``, so each
frame is decoded and uploaded once (an integer index of a ``LazyFrames`` is
one decode, and with OpenCV one seek). ``to_video`` scales each frame to uint8
on the device and downloads only the uint8 frames. ``to_ani`` and ``plot``
draw with matplotlib on the host.
"""

from __future__ import annotations

import copy
import logging
import os
from typing import Optional

import numpy as np
import torch

from .. import _device, _trace, const, helpers, ndx
from .._device import get_device, to_device, to_host, torch_dtype
from ..ops import filters as flt
from ..ops import ortho as ortho_ops
from ..ops import windows as win
from .orcbase import ORCBase
from .video import LazyFrames

__all__ = ["Frames"]

logger = logging.getLogger(__name__)

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("", "0", "false", "no", "off")


def _upload_crop_on() -> bool:
    """The upload crop of lazy stacks, unless ``PYORC_TPU_NO_UPLOAD_CROP`` is true."""
    value = os.environ.get("PYORC_TPU_NO_UPLOAD_CROP", "").strip().lower()
    if value not in _TRUE + _FALSE:
        raise ValueError(f"PYORC_TPU_NO_UPLOAD_CROP={value!r}: expected one of {_TRUE + _FALSE[1:]}")
    return value in _FALSE


class ChainOp:
    """A per-batch device op on a lazy stack's chain.

    ``halo`` is the op's spatial support radius in pixels (0 for elementwise
    ops, the stencil radius for convolutions): with it the op gives the same
    pixels on a batch cropped ``halo`` pixels beyond what later ops read, so
    ``project`` may crop before the upload. ``halo=None`` marks an op that
    needs the whole frame (normalize's per-frame extrema, the projection).
    Each call is a span (:mod:`pyorc_tpu_torch._trace`) named ``lazy:<name>``.
    """

    def __init__(self, fn, name: str, halo: Optional[int] = None):
        self.fn = fn
        self.name = name
        self.halo = halo
        self._span = f"lazy:{name}"

    def __call__(self, batch: torch.Tensor) -> torch.Tensor:
        with _trace.span(self._span):
            return self.fn(batch)


class PerDevice:
    """A constant of a per-frame op (normalize's mean image, project's index maps) on
    each device the op runs on: made with ``make(device)`` once per device, first on
    ``device``."""

    def __init__(self, make, device):
        self._make = make
        self._made = {}
        self(device)

    def __call__(self, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._made:
            self._made[device] = self._make(device)
        return self._made[device]


def _time_sharded(fn, chunk, devices) -> list:
    """``fn`` over ``chunk`` split along time into equal parts, one on each of ``devices``;
    the results on the host, in order (all launched before the first comes down)."""
    k = chunk.shape[0] // len(devices)
    parts = [fn(to_device(chunk[i * k : (i + 1) * k], device)) for i, device in enumerate(devices)]
    return [to_host(part) for part in parts]


@ndx.register_dataarray_accessor("frames")
class Frames(ORCBase):
    """Frame-stack functionality on an ndx.DataArray."""

    def __init__(self, obj):
        super().__init__(obj)

    @property
    def is_projected(self) -> bool:
        return all(coord in self._obj.coords for coord in ["xs", "ys"])

    def _device_batches(self, batch: int):
        """The stack on the device, ``batch`` frames at a time (a lazy stack's chain batches)."""
        data = self._obj.data
        if isinstance(data, LazyFrames):
            for _, chunk in data.iter_batches(batch):
                yield to_device(chunk)
        else:
            for start in range(0, data.shape[0], batch):
                yield to_device(data[start : start + batch])

    def _map_device(self, fn, name: str, batch: int = 64, out_dtype=None, halo: Optional[int] = None):
        """Apply a per-frame device op over the stack.

        A lazy stack stays lazy: the op joins its chain (see :class:`ChainOp`
        for ``halo``) and the result has dtype ``out_dtype`` (default: the
        stack's). An in-memory stack is mapped in device batches and comes
        back as a host array; where there is more than one local device and a
        batch's frame count is a multiple of their number, the batch is split
        over them along time.
        """
        data = self._obj.data
        if isinstance(data, LazyFrames):
            return data.with_op(ChainOp(fn, name, halo), dtype=out_dtype)
        devices = _device.local_devices()
        outs = []
        for start in range(0, data.shape[0], batch):
            chunk = data[start : start + batch]
            outs += _time_sharded(fn, chunk, devices if chunk.shape[0] % len(devices) == 0 else [get_device()])
        return np.concatenate(outs, axis=0)

    def _whole_on_device(self) -> torch.Tensor:
        """The whole stack on the device, for the ops that reduce or difference over time."""
        data = self._obj.data
        if isinstance(data, LazyFrames):
            return torch.cat(list(self._device_batches(64)), dim=0)
        return to_device(data)

    def _with_data(self, data, dims=None, drop_time: int = 0) -> ndx.DataArray:
        """New frames DataArray with the same coords and attrs (optionally the first frames dropped)."""
        obj = self._obj
        dims = obj.dims if dims is None else dims
        new = ndx.DataArray(data, dims=dims, name=obj.name, attrs=dict(obj.attrs), fastpath=True)
        for k, c in obj._coords.items():
            if drop_time and "time" in c.dims:
                new._coords[k] = c.isel(time=slice(drop_time, None))
            else:
                new._coords[k] = c
        return new

    def _require_gray(self, what: str, why: str) -> None:
        """The JAX package has no usable ``what`` of an RGB stack (``why``); neither has the port."""
        if "rgb" in self._obj.dims:
            raise NotImplementedError(
                f"{what} takes gray frames [time, y, x]: on an RGB stack the JAX package {why} "
                "(ROADMAP.md, queue C)."
            )

    # -- filters ------------------------------------------------------------

    def normalize(self, samples: int = 15) -> ndx.DataArray:
        """Remove the temporal mean of sampled frames. Reference frames.py:279-306."""
        self._require_gray("normalize", "rescales each image row by the extrema over (x, rgb), not each frame")
        n = self._obj.shape[0]
        time_interval = round(n / samples)
        if time_interval == 0:
            raise ValueError(f"Amount of frames is too small to provide {samples} samples")
        with _trace.span("frames:normalize_mean"):
            sampled = np.asarray(self._obj.data[::time_interval]).astype(np.float32)
            mean_host = sampled.mean(axis=0).astype(np.float32)
            mean = PerDevice(lambda device: to_device(mean_host, device), get_device())
        # each frame's rescale extrema are taken on the device over the whole
        # frame, so a lazy chain with normalize uploads whole frames (halo
        # None): at 4K this streams 6x faster than the JAX package's extrema
        # on the host with a cropped upload (PERF.md §6)
        out = self._map_device(lambda f: flt.normalize_with_mean(f, mean(f.device)), "normalize")
        return self._with_data(out)

    def edge_detect(self, wdw_1: int = 1, wdw_2: int = 2) -> ndx.DataArray:
        """Difference of two Gaussian blurs with half-widths ``wdw_1`` < ``wdw_2``, float32."""
        self._require_gray("edge_detect", "raises in its padding of three axes")
        stride_1 = wdw_1 * 2 + 1
        stride_2 = wdw_2 * 2 + 1
        out = self._map_device(
            lambda f: flt.edge_detect(f, stride_1, stride_2), "edge_detect", batch=16, out_dtype=np.float32,
            halo=max(stride_1, stride_2) // 2,
        )
        return self._with_data(out)

    def minmax(self, min: float = -np.inf, max: float = np.inf) -> ndx.DataArray:
        """Clip intensities to [min, max]; the frames keep their dtype (bounds outside it saturate)."""
        out = self._map_device(
            lambda f: flt.saturating_cast(flt.minmax(f, float(min), float(max)), f.dtype), "minmax", halo=0
        )
        return self._with_data(out)

    def range(self) -> ndx.DataArray:
        """Temporal intensity range per pixel (no time dimension)."""
        out = to_host(flt.frame_range(self._whole_on_device()))
        new = self._with_data(out, dims=tuple(d for d in self._obj.dims if d != "time"))
        new._coords = {k: c for k, c in new._coords.items() if "time" not in c.dims}
        return new

    def reduce_rolling(self, samples: int = 25) -> ndx.DataArray:
        """Remove the trailing rolling mean of ``samples`` frames; uint8, the first ``samples - 1`` frames 0."""
        self._require_gray("reduce_rolling", "raises in broadcasting its [time, 1, 1] mask")
        if self._obj.shape[0] < samples:
            raise ValueError(f"Amount of frames is smaller than rolling of {samples} samples")
        out = to_host(flt.reduce_rolling(self._whole_on_device(), samples))
        return self._with_data(out)

    def time_diff(self, thres: float = 0.0, abs: bool = False) -> ndx.DataArray:
        """Frame-to-frame differences above ``thres`` (else 0), float32; one frame fewer, the first time dropped."""
        out = to_host(flt.time_diff(self._whole_on_device(), float(thres), bool(abs)))
        return self._with_data(out, drop_time=1)

    def smooth(self, wdw: int = 1) -> ndx.DataArray:
        """Gaussian blur with a kernel of ``2 * wdw + 1`` px (OpenCV's kernel for sigma 0), float32."""
        self._require_gray("smooth", "raises in its padding of three axes")
        stride = wdw * 2 + 1
        out = self._map_device(
            lambda f: flt.gaussian_blur(f, stride), "smooth", batch=16, out_dtype=np.float32, halo=stride // 2
        )
        return self._with_data(out)

    # -- projection ------------------------------------------------------------

    def project(
        self,
        method: str = "numpy",
        resolution: Optional[float] = None,
        reducer: str = "mean",
    ) -> ndx.DataArray:
        """Orthorectify frames onto the water-surface plane grid.

        ``method="numpy"`` is the reference's name for the index-map
        projection (reference frames.py:199-277, project.py:164-230); here
        the per-frame work is a gather on the device, band by band for RGB
        frames [time, y, x, rgb]. ``method="cv"`` (the reference's OpenCV
        warp) runs the same index-map projection, as the JAX package runs it
        (:func:`pyorc_tpu_torch.project.project_cv` is the same alias).

        On a lazy stack the projection joins the op chain. When every op
        already on it declares a ``halo``, each decoded batch is cropped on
        the host to the source box the maps read (padded by the halos) and
        the maps are rebased onto it: the same pixels out, fewer bytes up.
        ``PYORC_TPU_NO_UPLOAD_CROP=1`` turns the crop off.
        """
        if method not in ("numpy", "cv"):
            raise ValueError(f"Selected projection method {method} does not exist.")
        cc = copy.deepcopy(self.camera_config)
        if resolution is not None:
            cc.resolution = resolution
        with _trace.span("frames:project_grid"):
            shape = cc.shape
            y = np.flipud(np.linspace(cc.resolution / 2, cc.resolution * (shape[0] - 0.5), shape[0]))
            x = np.linspace(cc.resolution / 2, cc.resolution * (shape[1] - 0.5), shape[1])
            cols, rows = np.meshgrid(np.arange(len(x)), np.arange(len(y)))
            xs, ys = helpers.get_xs_ys(cols, rows, cc.transform)
            if hasattr(cc, "crs"):
                lons, lats = helpers.get_lons_lats(xs, ys, cc.crs)
            else:
                lons, lats = None, None
            coords = {"y": y, "x": x}
        with _trace.span("frames:project_maps"):
            z = cc.get_z_a(self.h_a)
            maps = ortho_ops.build_ortho_maps(cc, x, y, z, reducer=reducer)
            is_rgb = "rgb" in self._obj.dims
            src_dtype = self._obj.dtype
            data = self._obj.data
            lazy = isinstance(data, LazyFrames)
            crop = None
            if lazy and data._crop is None and _upload_crop_on() and all(op.halo is not None for op in data._ops):
                box = ortho_ops.source_bbox(maps)
                if box is not None:
                    h, w = maps.shape_in
                    halo = sum(op.halo for op in data._ops)
                    r0, r1 = max(box[0] - halo, 0), min(box[1] + halo, h)
                    c0, c1 = max(box[2] - halo, 0), min(box[3] + halo, w)
                    if (r1 - r0) * (c1 - c0) <= 0.95 * h * w:
                        maps = ortho_ops.crop_maps(maps, r0, c0, r1 - r0, c1 - c0)
                        crop = (r0, r1, c0, c1)
            dmaps = PerDevice(lambda device: ortho_ops.device_maps(maps, device), get_device())

        def project_chunk(f):
            if is_rgb:
                bands = [ortho_ops.project_batch(f[..., b], maps, dmaps(f.device)) for b in range(f.shape[-1])]
                return torch.stack(bands, dim=-1)
            return ortho_ops.project_batch(f, maps, dmaps(f.device))

        if lazy:
            if crop is not None:
                pre_shape = (crop[1] - crop[0], crop[3] - crop[2]) + ((3,) if is_rgb else ())
                data = data.with_chain(data._ops, frame_shape=pre_shape, crop=crop)
            out_dtype = torch_dtype(src_dtype)
            out = data.with_op(
                ChainOp(lambda f: torch.nan_to_num(project_chunk(f)).to(out_dtype), "project"),
                frame_shape=(len(y), len(x)) + ((3,) if is_rgb else ()),
                dtype=src_dtype,
            )
        else:
            # the mapped stack is a fresh array: clean and cast it in place (whole-stack copies cost seconds at 4K)
            out = np.nan_to_num(self._map_device(project_chunk, "project", batch=32), copy=False)
            out = out.astype(src_dtype, copy=False)
        da_proj = ndx.DataArray(
            out,
            dims=("time", "y", "x", "rgb") if is_rgb else ("time", "y", "x"),
            coords={"time": self._obj["time"].values, **coords, **({"rgb": [0, 1, 2]} if is_rgb else {})},
            attrs=dict(self._obj.attrs),
            name="frames",
        )
        da_proj = da_proj.frames.add_xy_coords(
            {"xs": xs, "ys": ys, "lon": lons, "lat": lats}, coords, const.GEOGRAPHICAL_ATTRS
        )
        da_proj.attrs.update(camera_config=cc.to_json())
        return da_proj

    # -- PIV ------------------------------------------------------------

    def get_piv_coords(self, window_size, search_area_size, overlap):
        """Window-centre coordinates in all systems. Reference frames.py:47-112."""
        dim_size = self._obj.shape[1:3]
        cols_vector, rows_vector = win.get_rect_coordinates(
            dim_size=dim_size, window_size=window_size, search_area_size=search_area_size, overlap=overlap
        )
        cols, rows = np.meshgrid(cols_vector, rows_vector)
        x, y = helpers.get_axes(cols_vector, rows_vector, self._obj["x"].values, self._obj["y"].values)
        xs, ys = helpers.get_xs_ys(cols, rows, self.camera_config.transform)
        if hasattr(self.camera_config, "crs"):
            lons, lats = helpers.get_lons_lats(xs, ys, self.camera_config.crs)
        else:
            lons, lats = None, None
        z = self.camera_config.h_to_z(self.h_a)
        zs = np.ones(xs.shape) * z
        xp, yp = self.camera_config.project_grid(xs, ys, zs, swap_y_coords=True)
        coords = {"y": y, "x": x}
        mesh_coords = {"xp": xp, "yp": yp, "xs": xs, "ys": ys, "lon": lons, "lat": lats}
        return coords, mesh_coords

    def get_piv(
        self,
        window_size=None,
        overlap=None,
        engine: str = "jax",
        ensemble_corr: bool = False,
        **kwargs,
    ) -> ndx.Dataset:
        """PIV over projected frames -> Dataset(v_x, v_y, corr, s2n).

        Reference frames.py:114-197. ``engine`` takes the JAX package's names,
        "jax", "numba" and "numpy" (the last two the reference's, for its
        recipes); each runs this package's own route, as the JAX package runs
        its own, and any other name raises ``ValueError``. ``kwargs`` go to
        :func:`pyorc_tpu_torch.velocimetry.get_piv` (``chunksize``,
        ``memory_factor``, ``signal_threshold``, ``passes``, and for
        ``ensemble_corr=True`` the gates ``corr_min``, ``s2n_min`` and
        ``count_min``). ``ensemble_corr=True`` returns one time step: the
        displacement of the mean of the gated correlation planes of all pairs.
        ``passes=N`` (N > 1) runs multi-pass PIV with symmetric window
        deformation: N passes from ``2**(N-1)`` times the window down to the
        window, each deformed by the previous pass's field (an accuracy mode
        beyond the reference's single pass; not with ``ensemble_corr``).
        """
        from .. import velocimetry as engine_mod

        if engine not in ("jax", "numba", "numpy"):
            raise ValueError(f"Selected PIV engine {engine} does not exist.")
        if engine != "jax":
            logger.debug("engine=%r is accepted for recipe compatibility but runs this package's route.", engine)
        camera_config = copy.deepcopy(self.camera_config)
        dt = self._obj["time"].diff(dim="time")
        if window_size is not None:
            camera_config.window_size = window_size
        window_size = (
            2 * (camera_config.window_size,)
            if isinstance(camera_config.window_size, int)
            else tuple(camera_config.window_size)
        )
        window_size = win.round_to_even(window_size)
        search_area_size = window_size
        if overlap is None:
            # the configured size, before rounding to even: window 15 steps 9 px (16 - 7)
            configured = camera_config.window_size
            configured = 2 * (configured,) if isinstance(configured, int) else tuple(configured)
            overlap = tuple(int(round(w) / 2) for w in configured)
        coords, mesh_coords = self.get_piv_coords(window_size, search_area_size, overlap)
        kwargs = {
            **kwargs,
            "search_area_size": search_area_size,
            "window_size": window_size,
            "overlap": overlap,
            "res_x": camera_config.resolution,
            "res_y": camera_config.resolution,
        }
        ds = engine_mod.get_piv(
            self._obj, coords["y"], coords["x"], dt, ensemble_corr=ensemble_corr, **kwargs
        )
        ds = ds.velocimetry.add_xy_coords(
            mesh_coords, coords, {**const.PERSPECTIVE_ATTRS, **const.GEOGRAPHICAL_ATTRS}
        )
        ds.attrs = dict(self._obj.attrs)
        ds.attrs.update(camera_config=camera_config.to_json())
        ds.velocimetry.set_encoding()
        return ds

    def get_stiv(
        self,
        centers,
        angle: float,
        length: float,
        n_samples: int = None,
        window: int = 0,
        refine: int = 2,
        min_coherence: float = None,
    ) -> ndx.Dataset:
        """Space-Time Image Velocimetry along flow-aligned search lines.

        A capability the reference lists as wished-for but does not implement
        (reference README.md:22); see :mod:`pyorc_tpu_torch.ops.stiv`. Frames
        must be projected. For reliable streak angles pick ``n_samples`` so
        the expected displacement per frame stays under ~1.5 sample steps.

        Parameters
        ----------
        centers : [n_lines, 2] array
            line centre points (x, y) in the projected local coordinates
            (metres, same axes as the frames' x/y coords).
        angle : float
            flow direction in radians from +x toward +y (math convention).
        length : float
            search-line length in metres.
        n_samples : int, optional
            samples per line; default one per resolution step.
        window : int
            if > 0, returns a velocity profile along each line (dims
            ``(line, points)``) averaged over a box of this many samples.
        refine : int
            shear-refinement iterations for steep streaks.
        min_coherence : float, optional
            velocities whose coherence falls below this are set to NaN —
            where texture is weak or motion crosses the line, the streak
            angle (and hence v) is meaningless while coherence stays low.

        Returns
        -------
        ndx.Dataset with ``v`` (m/s, signed along the flow direction) and
        ``coherence`` (structure-tensor anisotropy in [0, 1], the STIV
        quality metric).
        """
        from ..ops import stiv as stiv_ops

        if not self.is_projected:
            raise ValueError("STIV requires projected frames (run frames.project() first)")
        self._require_gray("get_stiv", "raises in sampling [y, x, rgb] frames at (row, column) points")
        res = float(self.camera_config.resolution)
        x = self._obj["x"].values
        y = self._obj["y"].values
        centers = np.atleast_2d(np.asarray(centers, dtype=np.float64))
        cols_c = (centers[:, 0] - x[0]) / (x[1] - x[0])
        rows_c = (centers[:, 1] - y[0]) / (y[1] - y[0])
        if n_samples is None:
            n_samples = max(int(round(length / res)) + 1, 8)
        # y rows run opposite to +y: flip the angle's y component
        px_angle = np.arctan2(-np.sin(angle) * np.sign(y[0] - y[1]), np.cos(angle))
        rows, cols = stiv_ops.stiv_lines(
            np.stack([cols_c, rows_c], axis=1), px_angle, length / res, int(n_samples)
        )
        # the frames go up in their own dtype, batch by batch; only the
        # sampled points become float32, and the STI stays on the device
        rows_d, cols_d = to_device(rows), to_device(cols)
        sti = torch.cat([stiv_ops.build_sti(chunk, rows_d, cols_d) for chunk in self._device_batches(64)], dim=1)
        step_px = (length / res) / (n_samples - 1)
        dt = float(np.mean(np.diff(self._obj["time"].values)))
        v, coh = stiv_ops.sti_velocity(sti, step_px, dt, int(window), int(refine))
        v = to_host(v) * res  # px/s -> m/s
        coh = to_host(coh)
        if min_coherence is not None:
            v = np.where(coh >= min_coherence, v, np.nan)
        dims = ("line", "points") if window and window > 0 else ("line",)
        coords = {"line": np.arange(centers.shape[0])}
        if len(dims) == 2:
            coords["points"] = np.arange(v.shape[1])
        return ndx.Dataset(
            {
                "v": (dims, v.astype(np.float32), {"units": "m s-1", "long_name": "STIV streamwise velocity"}),
                "coherence": (dims, coh.astype(np.float32), {"units": "", "long_name": "STIV coherence"}),
            },
            coords={
                **coords,
                "xc": (("line",), centers[:, 0]),
                "yc": (("line",), centers[:, 1]),
            },
            attrs=dict(self._obj.attrs),
        )

    # -- output ------------------------------------------------------------

    def _host_frames(self, frames: slice = slice(None), batch: int = 16):
        """Yield (index, host frame) for the frames ``frames`` selects, in order. A lazy stack
        is read through its chain in batches: one decode and one upload a frame."""
        data = self._obj.data
        idx = range(data.shape[0])[frames]
        if isinstance(data, LazyFrames):
            for start, chunk in data[frames].iter_batches(batch):
                for k, frame in enumerate(to_host(chunk)):
                    yield idx[start + k], frame
        else:
            for i in idx:
                yield i, np.asarray(data[i])

    def to_video(self, fn, video_format=None, fps=None, progress=True):
        """Write the frames as a video (reference frames.py:537-607).

        Each frame becomes uint8 on the device as the JAX package makes it
        (:func:`pyorc_tpu_torch.ops.filters.video_uint8`), and only the uint8
        frames come down. The writer is chosen up front and logged: the native
        H.264 writer (``native/decoder.cpp``) where it builds, as in the JAX
        package, which ignores ``video_format``; else OpenCV's
        ``cv2.VideoWriter`` with ``video_format`` as its fourcc (default
        ``"mp4v"``), as the reference wrote and the JAX package's ``to_ani``
        falls back to.
        """
        if fps is None:
            diffs = np.diff(self._obj["time"].values)
            fps = 1.0 / diffs.mean() if len(diffs) else 25.0
        n, h, w = self._obj.shape[:3]
        writer = _video_writer(str(fn), w, h, float(fps), self._obj.ndim == 4, video_format)
        bar = _progress_bar(n, "Writing video", progress)
        try:
            for chunk in self._device_batches(16):
                for frame in to_host(flt.video_uint8(chunk)):
                    writer.write(frame)
                bar.update(chunk.shape[0])
        finally:
            writer.close()
            bar.close()

    def to_ani(
        self,
        fn,
        figure_kwargs=None,
        video_kwargs=None,
        anim_kwargs=None,
        progress_bar: bool = True,
        **kwargs,
    ):
        """Store an animation of the frames (reference frames.py:469-535), drawn with matplotlib
        on the host from the frames as :meth:`_host_frames` reads them."""
        import matplotlib.animation as animation
        import matplotlib.pyplot as plt

        figure_kwargs = const.FIGURE_ARGS if figure_kwargs is None else figure_kwargs
        video_kwargs = const.VIDEO_ARGS if video_kwargs is None else video_kwargs
        anim_kwargs = const.ANIM_ARGS if anim_kwargs is None else anim_kwargs

        fig = plt.figure(**figure_kwargs)
        ax = plt.subplot(111)
        ax.set_axis_off()
        fig.subplots_adjust(left=0, bottom=0, right=1, top=1, wspace=None, hspace=None)
        n = self._obj.shape[0]
        cursor = _FrameCursor(self)
        im = ax.imshow(cursor.frame(0), **kwargs)
        pbar = _progress_bar(n, "Writing animation", progress_bar)

        def update(i):
            im.set_data(cursor.frame(i))
            pbar.update(1)
            return (im,)

        if animation.writers.is_available("ffmpeg"):
            anim = animation.FuncAnimation(fig, update, frames=n, **anim_kwargs)
            anim.save(str(fn), **video_kwargs)
        else:
            # no ffmpeg CLI on PATH: render each figure frame and encode
            # with cv2's VideoWriter instead
            import cv2

            fps = video_kwargs.get("fps", 25)
            writer = None
            for i in range(n):
                update(i)
                fig.canvas.draw()
                rgba = np.asarray(fig.canvas.buffer_rgba())
                bgr = cv2.cvtColor(rgba, cv2.COLOR_RGBA2BGR)
                if writer is None:
                    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
                    writer = cv2.VideoWriter(str(fn), fourcc, fps, (bgr.shape[1], bgr.shape[0]))
                writer.write(bgr)
            if writer is not None:
                writer.release()
        pbar.close()
        plt.close(fig)

    def to_geotiffs(
        self,
        prefix: str,
        start_frame: int = None,
        end_frame: int = None,
        stride: int = 1,
        suffix: str = ".tif",
        progress_bar: bool = True,
    ):
        """Export frames as individual GeoTIFFs (reference frames.py:550-607).

        Files are named ``{prefix}_{frame:04d}{suffix}``. Frames must be
        projected. A lazy stack is read once through its chain (each frame
        decoded and uploaded once); each frame comes down in its own dtype,
        which the file keeps.
        """
        self._require_projected("GeoTIFF")
        n = self._obj.shape[0]
        start_frame = 0 if start_frame is None else start_frame
        end_frame = n if end_frame is None else min(end_frame, n)
        bar = _progress_bar(len(range(start_frame, end_frame, stride)), "Writing GeoTIFFs", progress_bar)
        fns = []
        try:
            for i, frame in self._host_frames(slice(start_frame, end_frame, stride)):
                fn = f"{prefix}_{i:04d}{suffix}"
                self._write_geotiff(fn, frame)
                fns.append(fn)
                bar.update(1)
        finally:
            bar.close()
        return fns

    def to_geotiff(self, fn, frame: int = 0, crs=None):
        """Write one projected frame as a GeoTIFF (pure-Python writer); a lazy stack reads that frame alone."""
        self._require_projected("GeoTIFF")
        self._write_geotiff(fn, np.asarray(self._obj.isel(time=frame).values), crs)

    def _require_projected(self, what: str) -> None:
        """Raise ``ValueError`` on frames that are not projected (the JAX package asserts)."""
        if not self.is_projected:
            raise ValueError(f"Frames must be projected before writing to {what}")

    def _write_geotiff(self, fn, data: np.ndarray, crs=None) -> None:
        from ..io.geotiff import write_geotiff

        cc = self.camera_config
        crs = crs if crs is not None else getattr(cc, "crs", None)
        write_geotiff(fn, data, cc.transform, crs=crs)

    def plot(self, ax=None, mode: str = "local", **kwargs):
        """Plot a single frame (time must already be selected)."""
        from .plot import frames_plot

        return frames_plot(self._obj, ax=ax, mode=mode, **kwargs)


class _FrameCursor:
    """Host frames of a stack by index for a reader that asks in order, as an animation does:
    the next index advances one stream over the stack (:meth:`Frames._host_frames`), the same
    index is served again, and an earlier one is read on its own."""

    def __init__(self, frames: Frames):
        self._frames = frames
        self._stream = frames._host_frames()
        self._index, self._frame = -1, None

    def frame(self, i: int) -> np.ndarray:
        while self._index < i:
            self._index, self._frame = next(self._stream)
        if self._index == i:
            return self._frame
        return np.asarray(self._frames._obj.data[i])


class _NoBar:
    def update(self, n=1):
        pass

    def close(self):
        pass


def _progress_bar(total: int, desc: str, enabled: bool):
    """A tqdm bar of ``total`` steps, or, when disabled, a stand-in (tqdm is not imported then)."""
    if not enabled:
        return _NoBar()
    from tqdm import tqdm

    return tqdm(total=total, desc=desc, position=0, leave=True)


class _Cv2Writer:
    """``cv2.VideoWriter`` behind the native writer's ``write`` / ``close``: RGB frames go in as
    BGR, which OpenCV encodes, so that a decode gives back the frames written."""

    def __init__(self, fn: str, width: int, height: int, fps: float, rgb: bool, fourcc: str):
        import cv2

        self._cv2 = cv2
        self._rgb = rgb
        self._out = cv2.VideoWriter(fn, cv2.VideoWriter_fourcc(*fourcc), fps, (width, height), isColor=rgb)
        if not self._out.isOpened():
            raise IOError(f"cv2.VideoWriter cannot write fourcc {fourcc!r} to {fn}")

    def write(self, frame: np.ndarray) -> None:
        frame = self._cv2.cvtColor(frame, self._cv2.COLOR_RGB2BGR) if self._rgb else frame
        self._out.write(np.ascontiguousarray(frame))

    def close(self) -> None:
        self._out.release()


def _video_writer(fn: str, width: int, height: int, fps: float, rgb: bool, video_format=None):
    """The writer :meth:`Frames.to_video` uses, chosen before the first frame and logged."""
    from ..io import native_decoder

    if native_decoder.encoder_available():
        logger.info(f"to_video: native H.264 writer (native/decoder.cpp) -> {fn}")
        return native_decoder.NativeVideoWriter(fn, width, height, fps=fps, channels=3 if rgb else 1)
    fourcc = video_format or "mp4v"
    reason = (native_decoder.load_error() or "unavailable").splitlines()[0]
    logger.info(f"to_video: cv2.VideoWriter, fourcc {fourcc!r} -> {fn} (no native encoder: {reason})")
    return _Cv2Writer(fn, width, height, fps, rgb, fourcc)
