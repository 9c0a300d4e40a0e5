"""Velocimetry accessor: validity checks, masks, transect sampling, exports.

Parity port of the reference accessor (reference ``pyorc/api/velocimetry.py``)
on the ndx data model.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from .. import _trace, const, helpers, ndx
from ..geom import aoi as aoi_mod
from ..geom import crs as crs_mod
from .mask import _Velocimetry_MaskMethods
from .orcbase import ORCBase

__all__ = ["Velocimetry"]


def _window_effective(ds, cells, tolerance, **window) -> ndx.Dataset:
    """``get_transect``'s windowed field: at ``cells`` ({"y": rows, "x": cols}) the median over
    :func:`helpers.stack_window`'s strides (``window``), where more than ``tolerance`` of the strides
    have a valid time mean; NaN at every other cell of the grid.

    The reference computes it on the whole stacked field; each cell's value
    depends only on its own strides, so at ``cells`` it is the same.
    """
    ds_wdw = helpers.stack_window_cells(ds, cells, **window)
    missing_tolerance = ds_wdw.mean(dim="time").count(dim="stride") > tolerance * ds_wdw.sizes["stride"]
    effective = ds_wdw.median(dim="stride").where(missing_tolerance)

    def grid(v):
        values = effective[v.name].values  # [other dims, cell]
        lead = tuple(n for d, n in zip(v.dims, v.shape) if d not in ("y", "x"))
        field = np.full(lead + (v.sizes["y"], v.sizes["x"]), np.nan, dtype=values.dtype)
        field[..., cells["y"], cells["x"]] = values
        return v._replace(np.moveaxis(field, (-2, -1), (v.dims.index("y"), v.dims.index("x"))))

    return ds._map(grid)


@ndx.register_dataset_accessor("velocimetry")
class Velocimetry(ORCBase):
    """Velocimetry functionality on a Dataset from Frames.get_piv."""

    def __init__(self, obj):
        super().__init__(obj)

    @property
    def is_velocimetry(self) -> bool:
        """Heuristic check that the Dataset holds velocimetry results."""
        unknown_dims = set(self._obj.sizes).difference({"time", "y", "x"})
        if unknown_dims:
            print(f"Unknown dimension(s) found: {unknown_dims}")
            return False
        missed_dims = {"y", "x"}.difference(set(self._obj.sizes))
        if missed_dims:
            print(f"Dimensions missing: {missed_dims}")
            return False
        missed_vars = set(const.ENCODE_VARS).difference(set(self._obj.data_vars))
        if missed_vars:
            print(f"Variables missing: {missed_vars}")
            return False
        if "camera_config" not in self._obj.attrs:
            print("camera_config metadata is missing")
            return False
        return True

    @property
    def mask(self):
        return _Velocimetry_MaskMethods(self)

    def add_xy_coords(self, xy_coord_data, coords, attrs_dict):
        return ORCBase.add_xy_coords(self, xy_coord_data, coords, attrs_dict)

    def set_encoding(self, enc_pars=None):
        enc_pars = const.ENCODING_PARAMS if enc_pars is None else enc_pars
        for k in const.ENCODE_VARS:
            self._obj.encoding[k] = dict(enc_pars)

    @_trace.spanned("transect:get_transect")
    def get_transect(
        self,
        x,
        y,
        z=None,
        s=None,
        crs=None,
        v_eff: bool = True,
        xs: str = "xs",
        ys: str = "ys",
        distance: Optional[float] = None,
        wdw: int = 1,
        wdw_x_min=None,
        wdw_x_max=None,
        wdw_y_min=None,
        wdw_y_max=None,
        rolling: Optional[int] = None,
        tolerance: float = 0.5,
        quantiles=None,
    ) -> ndx.Dataset:
        """Sample all variables over a cross-section -> quantile Dataset on "points".

        Reference pyorc/api/velocimetry.py:69-234.
        """
        from .cameraconfig import xyz_transform

        if quantiles is None:
            quantiles = [0.05, 0.25, 0.5, 0.75, 0.95]
        transform = helpers.affine_from_grid(self._obj[xs].values, self._obj[ys].values)
        x = list(np.asarray(x, dtype=np.float64))
        y = list(np.asarray(y, dtype=np.float64))
        if crs is not None:
            pts = xyz_transform(list(zip(x, y)), crs, crs_mod.CRS.from_user_input(self.camera_config.crs))
            x, y = list(np.array(pts)[:, 0]), list(np.array(pts)[:, 1])
        if s is None:
            if distance is None:
                distance = float(np.abs(np.diff(self._obj["x"].values)[0]))
            if z is None:
                x, y, s = helpers.xy_equidistant(x, y, distance=distance)
                z = None
            else:
                x, y, z, s = helpers.xy_equidistant(x, y, distance=distance, z=z)

        # fractional row/col of the sample points in the (possibly rotated) grid
        from ..geom.affine import map_to_pixel_float

        rows, cols = map_to_pixel_float(np.asarray(x), np.asarray(y), transform)
        from scipy.interpolate import interp1d

        f_x = interp1d(np.arange(0, self._obj.sizes["x"]), self._obj["x"].values, fill_value="extrapolate")
        f_y = interp1d(np.arange(0, self._obj.sizes["y"]), self._obj["y"].values, fill_value="extrapolate")
        _x = ndx.DataArray(f_x(cols), dims=("points",))
        _y = ndx.DataArray(f_y(rows), dims=("points",))

        ds = self._obj[["v_x", "v_y", "s2n", "corr"]]
        if wdw == 0:
            # nearest-neighbour sampling
            ds_points = ds.interp(x=_x, y=_y)  # linear is fine at window centres
        else:
            # the window median on the cells the sample points' stencils read: interp reads no other
            ds_effective = _window_effective(
                ds, ds["v_x"].interp_cells(x=_x, y=_y), tolerance,
                wdw=wdw, wdw_x_min=wdw_x_min, wdw_x_max=wdw_x_max, wdw_y_min=wdw_y_min, wdw_y_max=wdw_y_max,
            )
            ds_points = ds_effective.interp(x=_x, y=_y)
        if bool(np.isnan(ds_points["v_x"].mean(dim="time").values).all()):
            warnings.warn(
                "No valid velocimetry points found over bathymetry. Check if the bathymetry is within the "
                "camera objective.",
                stacklevel=2,
            )
        ds_points = ds_points.assign_coords(xcoords=(("points",), np.asarray(x)))
        ds_points = ds_points.assign_coords(ycoords=(("points",), np.asarray(y)))
        ds_points = ds_points.assign_coords(scoords=(("points",), np.asarray(s)))
        if z is not None:
            ds_points = ds_points.assign_coords(zcoords=(("points",), np.asarray(z)))
        # flow angle in the LOCAL GRID system (v_x/v_y are grid-aligned), from
        # the sampled grid coordinates — reference velocimetry.py:217
        alpha = helpers.xy_angle(_x.values, _y.values)
        flow_dir = alpha - 0.5 * np.pi
        ds_points["v_dir"] = (("points",), flow_dir, {
            "standard_name": "river_flow_angle",
            "long_name": "Angle of river flow in radians from North",
            "units": "rad",
        })
        if rolling is not None:
            rolled = ds_points[["v_x", "v_y", "s2n", "corr"]].rolling(time=rolling, min_periods=1).mean()
            for k in ("v_x", "v_y", "s2n", "corr"):
                ds_points[k] = rolled[k]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            qds = ds_points[["v_x", "v_y", "s2n", "corr"]].quantile(quantiles, dim="time")
        for k in ("v_x", "v_y", "s2n", "corr"):
            qds[k].attrs = dict(ds_points[k].attrs)
        qds["v_dir"] = ds_points["v_dir"]
        qds.attrs = dict(self._obj.attrs)
        if v_eff:
            qds.transect.vector_to_scalar()
        return qds

    def to_ugrid(self, time0=None, title=None, fill_na=None) -> ndx.Dataset:
        """UGRID-1.0 mesh export for QGIS. Reference velocimetry.py:255-310.

        Host numpy on the Dataset's arrays, as in the JAX package: the fields
        came down from the device when ``get_piv`` returned."""
        from ..io import ugrid as ugrid_io

        resolution = float(np.mean(np.diff(self._obj["x"].values)))
        aff = aoi_mod.get_transform(self.camera_config.bbox, resolution)
        theta = np.arctan2(aff[3], aff[0])
        ucx, ucy = helpers.rotate_u_v(self._obj["v_x"].values, -self._obj["v_y"].values, theta)
        crs = getattr(self.camera_config, "crs", None)
        data_vars = {
            "mesh2d_ucx": ucx,
            "mesh2d_ucy": ucy,
            "s2n": self._obj["s2n"].values,
            "corr": self._obj["corr"].values,
        }
        time = self._obj["time"].values if "time" in self._obj.sizes else np.array([0.0])
        return ugrid_io.to_ugrid(
            data_vars=data_vars,
            x=self._obj["x"].values,
            y=self._obj["y"].values,
            time=np.atleast_1d(time),
            aff=aff,
            crs=crs,
            time0=time0,
            title=title,
            fill_na=fill_na,
        )

    @property
    def plot(self):
        """Plot methods object: callable (defaults to quiver) and exposing
        .quiver/.pcolormesh/.scatter/.streamplot/.get_uv_* (reference
        api/plot.py)."""
        from .plot import _Velocimetry_PlotMethods

        return _Velocimetry_PlotMethods(self)
