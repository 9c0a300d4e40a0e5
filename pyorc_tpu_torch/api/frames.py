"""Frames accessor: normalization, orthorectification, PIV entry point.

Port of :mod:`pyorc_tpu.api.frames` (reference ``pyorc/api/frames.py``) for
in-memory frame stacks: each op uploads the stack to the device in batches,
runs there as PyTorch ops (:mod:`pyorc_tpu_torch.ops.filters`,
:mod:`pyorc_tpu_torch.ops.ortho`), and returns host arrays; the PIV loop,
time-resolved or ensemble, streams through the CUDA kernels
(:mod:`pyorc_tpu_torch.velocimetry`). Lazy
video-backed stacks, the other filters, STIV and the exports are not ported
yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from .. import const, helpers, ndx
from .._device import get_device
from ..ops import filters as flt
from ..ops import ortho as ortho_ops
from ..ops import windows as win
from .orcbase import ORCBase

__all__ = ["Frames"]


@ndx.register_dataarray_accessor("frames")
class Frames(ORCBase):
    """Frame-stack functionality on an ndx.DataArray."""

    def __init__(self, obj):
        super().__init__(obj)

    @property
    def is_projected(self) -> bool:
        return all(coord in self._obj.coords for coord in ["xs", "ys"])

    def _map_device(self, fn, batch: int = 64) -> np.ndarray:
        """Apply a per-frame device op over the stack in batches; returns a host array."""
        device = get_device()
        data = self._obj.data
        n = data.shape[0]
        outs = []
        for start in range(0, n, batch):
            chunk = torch.as_tensor(np.ascontiguousarray(data[start : min(start + batch, n)])).to(device)
            outs.append(fn(chunk).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def _with_data(self, data, dims=None) -> ndx.DataArray:
        """New frames DataArray with the same coords and attrs."""
        obj = self._obj
        dims = obj.dims if dims is None else dims
        new = ndx.DataArray(data, dims=dims, name=obj.name, attrs=dict(obj.attrs), fastpath=True)
        new._coords.update(obj._coords)
        return new

    def _require_gray(self, what: str) -> None:
        if "rgb" in self._obj.dims:
            raise NotImplementedError(f"{what} of RGB frames is not ported to pyorc_tpu_torch yet (ROADMAP.md, queue A).")

    # -- filters ------------------------------------------------------------

    def normalize(self, samples: int = 15) -> ndx.DataArray:
        """Remove the temporal mean of sampled frames. Reference frames.py:279-306."""
        self._require_gray("normalize")
        n = self._obj.shape[0]
        time_interval = round(n / samples)
        if time_interval == 0:
            raise ValueError(f"Amount of frames is too small to provide {samples} samples")
        sampled = np.asarray(self._obj.data[::time_interval]).astype(np.float32)
        mean = torch.as_tensor(sampled.mean(axis=0).astype(np.float32)).to(get_device())
        out = self._map_device(lambda f: flt.normalize_with_mean(f, mean))
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
        the per-frame work is a gather on the device. ``method="cv"`` (the
        reference's OpenCV warp) raises: this package has no OpenCV path.
        """
        if method == "cv":
            raise NotImplementedError('project(method="cv") is not supported by pyorc_tpu_torch; use method="numpy".')
        if method != "numpy":
            raise ValueError(f"Selected projection method {method} does not exist.")
        self._require_gray("project")
        cc = copy.deepcopy(self.camera_config)
        if resolution is not None:
            cc.resolution = resolution
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
        z = cc.get_z_a(self.h_a)
        maps = ortho_ops.build_ortho_maps(cc, x, y, z, reducer=reducer)
        dmaps = ortho_ops.device_maps(maps, get_device())
        src_dtype = self._obj.dtype
        out = self._map_device(lambda f: ortho_ops.project_batch(f, maps, dmaps), batch=32)
        out = np.nan_to_num(out).astype(src_dtype)
        da_proj = ndx.DataArray(
            out,
            dims=("time", "y", "x"),
            coords={"time": self._obj["time"].values, **coords},
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
        ensemble_corr: bool = False,
        **kwargs,
    ) -> ndx.Dataset:
        """PIV over projected frames -> Dataset(v_x, v_y, corr, s2n).

        Reference frames.py:114-197. ``kwargs`` go to
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
            overlap = 2 * (int(round(camera_config.window_size) / 2),)
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
