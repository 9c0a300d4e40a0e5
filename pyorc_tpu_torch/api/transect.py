"""Transect accessor: effective velocity, depth integration, discharge.

Parity port of reference ``pyorc/api/transect.py`` on the ndx data model.
"""

from __future__ import annotations

import numpy as np

from .. import helpers, ndx
from .orcbase import ORCBase

__all__ = ["Transect"]


@ndx.register_dataset_accessor("transect")
class Transect(ORCBase):
    """Transect functionality on a Dataset from Velocimetry.get_transect."""

    def __init__(self, obj):
        super().__init__(obj)

    @property
    def cross_section(self):
        if "zcoords" not in self._obj.coords:
            return None
        from .cross_section import CrossSection

        coords = [
            [float(_x), float(_y), float(_z)]
            for _x, _y, _z in zip(
                self._obj["xcoords"].values, self._obj["ycoords"].values, self._obj["zcoords"].values
            )
        ]
        return CrossSection(camera_config=self.camera_config, cross_section=coords)

    @property
    def wetted_surface_polygon(self):
        return self.cross_section.get_wetted_surface_sz(self.h_a)

    @property
    def wetted_perimeter_linestring(self):
        return self.cross_section.get_wetted_surface_sz(self.h_a, perimeter=True)

    @property
    def wetted_surface(self) -> float:
        return self.wetted_surface_polygon.area

    @property
    def wetted_perimeter(self) -> float:
        return self.wetted_perimeter_linestring.length

    def vector_to_scalar(self, v_x: str = "v_x", v_y: str = "v_y"):
        """Project velocity vectors onto the cross-section normal ("v_eff_nofill")."""
        v_angle = np.arctan2(self._obj[v_x].values, self._obj[v_y].values)
        v_scalar = (self._obj[v_x] ** 2 + self._obj[v_y] ** 2) ** 0.5
        flow_dir = self._obj["v_dir"]
        angle_diff = v_angle - flow_dir.values[None, :]
        v_eff_vals = np.cos(angle_diff) * v_scalar.values
        v_eff = v_scalar._replace(v_eff_vals)
        v_eff.attrs = {
            "standard_name": "velocity",
            "long_name": "velocity in perpendicular direction of cross section, measured by angle in radians, "
            "measured from up-direction",
            "units": "m s-1",
        }
        v_eff.name = "v_eff_nofill"
        self._obj["v_eff_nofill"] = v_eff

    def get_transect_perspective(self, h=None, within_image=True):
        """Project transect coordinates to image (col, row). Reference transect.py:123-151."""
        x = self._obj["xcoords"].values
        y = self._obj["ycoords"].values
        if h is not None:
            z_surface = h - self.camera_config.gcps["h_ref"] + self.camera_config.gcps["z_0"]
            z = np.ones(len(x)) * z_surface
        else:
            z = self._obj["zcoords"].values
        points = np.column_stack([x, y, z])
        return self.camera_config.project_points(points, within_image=within_image, swap_y_coords=True)

    def get_bottom_surface_z_perspective(self, h, sample_size=1000, interval=None):
        """Densified bottom/surface transect points in image perspective."""
        bottom_points = self.get_transect_perspective(within_image=True)
        surface_points = self.get_transect_perspective(h=h, within_image=True)
        bottom_points = helpers.densify_points(bottom_points, sample_size=sample_size)
        surface_points = helpers.densify_points(surface_points, sample_size=sample_size)
        z_points = helpers.densify_points(self._obj["zcoords"].values, sample_size=sample_size)
        if interval is not None:
            bottom_points = bottom_points[::interval]
            surface_points = surface_points[::interval]
            z_points = z_points[::interval]
        z_surface = h - self.camera_config.gcps["h_ref"] + self.camera_config.gcps["z_0"]
        mask = z_points < z_surface
        return np.array(bottom_points)[mask], np.array(surface_points)[mask]

    def get_depth_perspective(self, h, sample_size=1000, interval=25):
        """Depth lines (bottom->surface point pairs) in image perspective."""
        bottom_points, surface_points = self.get_bottom_surface_z_perspective(
            h=h, sample_size=sample_size, interval=interval
        )
        return list(zip(bottom_points, surface_points))

    def get_v_surf(self, v_name: str = "v_eff"):
        """Mean surface velocity over the wetted part. Reference transect.py:177-210."""
        z_a = self.camera_config.h_to_z(self.h_a)
        depth = z_a - self._obj["zcoords"].values
        depth[depth < 0] = 0.0
        wet_scoords = self._obj["scoords"].values[depth > 0]
        if len(wet_scoords) == 0:
            return np.nan
        if len(wet_scoords) > 1:
            velocity_int = self._obj[v_name].fillna(0.0).integrate(coord="scoords")
            width = (wet_scoords[-1] + (wet_scoords[-1] - wet_scoords[-2]) * 0.5) - (
                wet_scoords[0] - (wet_scoords[1] - wet_scoords[0]) * 0.5
            )
            return velocity_int / width
        return self._obj[v_name].isel(points=np.where(depth > 0)[0])

    def get_v_bulk(self, q_name: str = "q"):
        """Bulk velocity = discharge / wetted surface. Reference transect.py:212-229."""
        discharge = self._obj[q_name].fillna(0.0).integrate(coord="scoords")
        return discharge / self.wetted_surface

    def get_river_flow(self, q_name: str = "q", discharge_name: str = "river_flow"):
        """Integrate q over the cross-section into river flow [m3 s-1]."""
        if q_name not in self._obj:
            raise ValueError(
                f'Dataset must contain variable "{q_name}" (depth-integrated velocity [m2 s-1]); '
                "create it with ds.transect.get_q"
            )
        discharge = self._obj[q_name].fillna(0.0).integrate(coord="scoords")
        discharge.attrs = {
            "standard_name": "river_discharge",
            "long_name": "River Flow",
            "units": "m3 s-1",
        }
        discharge.name = "Q"
        self._obj[discharge_name] = discharge

    def get_q(self, v_corr: float = 0.9, fill_method: str = "zeros") -> ndx.Dataset:
        """Depth-integrated velocity per point with gap filling. Reference transect.py:262-319."""
        assert fill_method in ["zeros", "log_fit", "log_interp", "interpolate"], (
            f'fill_method must be "zeros", "log_fit", "log_interp", or "interpolate", got "{fill_method}"'
        )
        ds = self._obj
        x = ds["xcoords"].values
        y = ds["ycoords"].values
        z = ds["zcoords"].values
        depth = self.camera_config.get_depth(z, self.h_a)
        # zero out velocities where depth is zero
        v_nofill = ds["v_eff_nofill"].copy(deep=True)
        vals = v_nofill.values.copy()
        vals[:, depth <= 0] = 0.0
        v_nofill = v_nofill._replace(vals)
        ds["v_eff_nofill"] = v_nofill
        if fill_method == "zeros":
            ds["v_eff"] = ds["v_eff_nofill"].fillna(0.0)
        elif fill_method == "log_fit":
            dist_shore = self.camera_config.get_dist_shore(x, y, z, self.h_a)
            ds["v_eff"] = helpers.velocity_log_fit(ds["v_eff_nofill"], depth, dist_shore, dim="quantile")
        elif fill_method == "log_interp":
            dist_wall = self.camera_config.get_dist_wall(x, y, z, self.h_a)
            ds["v_eff"] = helpers.velocity_log_interp(ds["v_eff_nofill"], dist_wall, dim="quantile")
        elif fill_method == "interpolate":
            v_eff = ds["v_eff_nofill"].interpolate_na(dim="points")
            depth_da = ds["zcoords"] * 0 + depth
            v_eff = v_eff.where(depth_da > 0)
            ds["v_eff"] = v_eff.fillna(0.0)
        depth_da = ndx.DataArray(depth, dims=("points",))
        ds["q_nofill"] = helpers.depth_integrate(depth_da, ds["v_eff_nofill"], v_corr=v_corr, name="q_nofill")
        ds["q"] = helpers.depth_integrate(depth_da, ds["v_eff"], v_corr=v_corr, name="q")
        return ds

    @property
    def plot(self):
        """Plot methods object: callable (defaults to quiver) and exposing
        .quiver/.pcolormesh/.scatter/.streamplot/.get_uv_* (reference
        api/plot.py)."""
        from .plot import _Transect_PlotMethods

        return _Transect_PlotMethods(self)
