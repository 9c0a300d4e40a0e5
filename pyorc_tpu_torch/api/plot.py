"""Plotting for frames, velocimetry fields and transects.

Covers the reference's three plot perspectives (reference ``pyorc/api/plot.py``):
``local`` (ortho metres), ``geographical`` (lon/lat) and ``camera`` (vectors
re-projected into the original camera image by displacing each point by
dt*v and projecting both ends — reference plot.py:552-604). Helper parity:
``cbar`` (inset colorbar with outlined labels, reference plot.py:698-741),
``plot_text`` (transect discharge summary, reference plot.py:743-791), and
the transect overlay machinery (cross-section line / camera-perspective
wetted surface + water level + depth lines, reference plot.py:160-240).

A copy of :mod:`pyorc_tpu.api.plot` on the port's accessors: host matplotlib
over the host arrays of a reduced Dataset or a single frame. matplotlib is
imported inside the functions; the card's machine has none, so figures are
made where it is installed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import helpers

__all__ = [
    "frames_plot",
    "cbar",
    "plot_text",
    "_Velocimetry_PlotMethods",
    "_Transect_PlotMethods",
]


_LINE_COLOR = "#385895"  # cross-section line color (matches the reference)


def _get_ax(ax=None, figsize=(13, 8)):
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=figsize)
    return ax


def _path_effects():
    from matplotlib import patheffects

    return [patheffects.Stroke(linewidth=2, foreground="w"), patheffects.Normal()]


def cbar(ax, p, size: float = 12, loc: int = 0, **kwargs):
    """Inset colorbar with white-outlined labels (reference plot.py:698-741).

    ``loc``: 0 lower left, 1 lower right, 2 upper right, 3 upper left.
    """
    import matplotlib.ticker as mticker

    insets = {
        1: [0.9, 0.05, 0.02, 0.25],
        2: [0.9, 0.7, 0.02, 0.25],
        3: [0.05, 0.7, 0.02, 0.25],
    }
    cax = ax.inset_axes(insets.get(loc, [0.05, 0.05, 0.02, 0.25]))
    cb = ax.figure.colorbar(p, cax=cax, **kwargs)
    ticks = cb.get_ticks().tolist()
    cb.set_ticks(mticker.FixedLocator(ticks))
    cb.set_ticklabels(
        ["{:,.2f}".format(t) for t in ticks], path_effects=_path_effects(), fontsize=size
    )
    cb.set_label(label="velocity [m/s]", size=size, path_effects=_path_effects())
    return cb


def plot_text(ax, ds, prefix: str = "", suffix: str = ""):
    """Standardized transect info text: h_a, surface/bulk velocity, discharge
    (reference plot.py:743-791). No-op when the transect carries no ``q``."""
    import copy as _copy

    if "q" not in ds:
        return None
    _ds = _copy.deepcopy(ds)
    _ds.transect.get_river_flow(q_name="q")
    q_total = float(np.abs(_ds["river_flow"].values).max())
    v_surf = float(np.asarray(_ds.transect.get_v_surf()))
    v_bulk = float(np.asarray(_ds.transect.get_v_bulk()))
    string = prefix + (
        f"$h_a$: {_ds.transect.h_a:1.2f} m | "
        f"$v_{{surf}}$: {v_surf:1.2f} m/s | "
        f"$\\overline{{v}}$: {v_bulk:1.2f} m/s\n"
        f"$Q$: {q_total:1.2f} m3/s"
    )
    if "q_nofill" in ds:
        _ds.transect.get_river_flow(q_name="q_nofill")
        q_nofill = float(np.abs(_ds["river_flow"].values).max())
        if q_total > 0:
            string += " ({:1.0f}% measured)".format(q_nofill / q_total * 100)
    string += suffix
    return ax.text(
        0.95, 0.95, string, size=18, horizontalalignment="right",
        verticalalignment="top", path_effects=_path_effects(), transform=ax.transAxes,
    )


def _check_reduced(obj):
    """Time-resolved data must be reduced before plotting (reference
    plot.py:117-124) — quietly averaging would hide the dynamics."""
    if "time" in obj.coords and np.asarray(obj["time"].values).size > 1:
        raise AttributeError(
            f'Object contains dimension "time" with length '
            f"{np.asarray(obj['time'].values).size}. Reduce the dataset by "
            "selecting one time step or taking a median, mean or other statistic."
        )


def _geo_ax(obj, ax=None, tiles=None, zoom_level=18, tiles_kwargs=None):
    """Axes for geographical mode, with an optional XYZ basemap underneath
    (reference plot.py builds cartopy GeoAxes with image tilers; here the
    self-contained fetcher in io/basemap draws onto a plain lon/lat axes)."""
    ax = _get_ax(ax)
    if tiles is not None and "lon" in obj.coords:
        import warnings

        from ..io import basemap

        lon = obj["lon"].values
        lat = obj["lat"].values
        pad_lon = max((np.nanmax(lon) - np.nanmin(lon)) * 0.25, 1e-4)
        pad_lat = max((np.nanmax(lat) - np.nanmin(lat)) * 0.25, 1e-4)
        extent = (
            float(np.nanmin(lon) - pad_lon),
            float(np.nanmax(lon) + pad_lon),
            float(np.nanmin(lat) - pad_lat),
            float(np.nanmax(lat) + pad_lat),
        )
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # offline fallback stays quiet here
            basemap.add_basemap(ax, extent, tiles=tiles, zoom_level=zoom_level, **(tiles_kwargs or {}))
    return ax


def frames_plot(da, ax=None, mode: str = "local", **kwargs):
    """Plot a single frame in the chosen perspective.

    Handles grayscale and RGB frames (reference _frames_plot,
    plot.py:244-330): local mode uses the fast ``imshow`` path over the
    regular metre grid; camera/geographical modes draw a QuadMesh over the
    perspective/geographic coordinate rasters.
    """
    _check_reduced(da)
    ax = _get_ax(ax)
    vals = np.asarray(da.data)
    is_rgb = vals.ndim == 3 and vals.shape[-1] in (3, 4)
    style = {} if is_rgb else {"cmap": "gray"}
    if mode == "camera":
        x = da["xp"].values if "xp" in da.coords else np.arange(vals.shape[1])
        y = da["yp"].values if "yp" in da.coords else np.arange(vals.shape[0])
        ax.pcolormesh(x, y, vals, **(style | kwargs))
    elif mode == "geographical":
        ax.pcolormesh(da["lon"].values, da["lat"].values, vals, **(style | kwargs))
    elif "x" in da.coords and np.asarray(da["x"].values).ndim == 1:
        # regular local grid: imshow is much faster than a QuadMesh
        xv = np.asarray(da["x"].values)
        yv = np.asarray(da["y"].values)
        dx = abs(float(xv[1] - xv[0])) if len(xv) > 1 else 1.0
        dy = abs(float(yv[1] - yv[0])) if len(yv) > 1 else 1.0
        extent = [xv.min() - dx / 2, xv.max() + dx / 2, yv.min() - dy / 2, yv.max() + dy / 2]
        show = vals
        if is_rgb and show.dtype != np.uint8:
            show = np.clip(show, 0, 255).astype(np.uint8)
        ax.imshow(show, origin="upper", extent=extent, aspect="auto", **(style | kwargs))
    else:
        ax.pcolormesh(da["xs"].values, da["ys"].values, vals, **(style | kwargs))
    ax.set_aspect("equal")
    return ax


class _BasePlot:
    def __init__(self, ref):
        self.ref = ref
        self._obj = ref._obj

    def _mode_ax(self, mode, ax, kwargs):
        """Pop tile kwargs and build the right axes for the plot mode."""
        _check_reduced(self._obj)
        tiles = kwargs.pop("tiles", None)
        zoom_level = kwargs.pop("zoom_level", 18)
        tiles_kwargs = kwargs.pop("tiles_kwargs", None)
        if mode == "geographical":
            return _geo_ax(self._obj, ax, tiles=tiles, zoom_level=zoom_level, tiles_kwargs=tiles_kwargs)
        return _get_ax(ax)

    def _coords(self, mode: str):
        obj = self._obj
        if mode == "local":
            return obj["x"].values, obj["y"].values, "1d"
        if mode == "geographical":
            return obj["lon"].values, obj["lat"].values, "2d"
        if mode == "camera":
            return obj["xp"].values, obj["yp"].values, "2d"
        raise ValueError(f"mode {mode} unknown")

    def _uv(self, mode: str):
        u = self._obj["v_x"].values
        v = self._obj["v_y"].values
        if u.ndim == 3:  # reduce time if present
            u = np.nanmean(u, axis=0)
            v = np.nanmean(v, axis=0)
        if mode == "camera":
            # displace each grid point by dt*v in world coords and project both
            # ends to the camera to get image-space vectors
            cc = self.ref.camera_config
            xs = self._obj["xs"].values
            ys = self._obj["ys"].values
            z = cc.get_z_a(self.ref.h_a)
            dt = 0.1
            pts0 = np.column_stack([xs.ravel(), ys.ravel(), np.full(xs.size, z)])
            pts1 = np.column_stack(
                [(xs + u * dt).ravel(), (ys + v * dt).ravel(), np.full(xs.size, z)]
            )
            p0 = cc.project_points(pts0, swap_y_coords=True)
            p1 = cc.project_points(pts1, swap_y_coords=True)
            u_c = ((p1[:, 0] - p0[:, 0]) / dt).reshape(xs.shape)
            v_c = ((p1[:, 1] - p0[:, 1]) / dt).reshape(xs.shape)
            return u_c, v_c
        if mode == "geographical":
            # rotate to east/north components
            aff = helpers.affine_from_grid(self._obj["xs"].values, self._obj["ys"].values)
            theta = np.arctan2(aff[3], aff[0])
            return helpers.rotate_u_v(u, v, theta)
        return u, v


class _Velocimetry_PlotMethods(_BasePlot):
    def __call__(self, method: str = "quiver", mode: str = "local", ax=None, add_colorbar: bool = False, **kwargs):
        return getattr(self, method)(mode=mode, ax=ax, add_colorbar=add_colorbar, **kwargs)

    # (u, v, s) accessors per projection, reference plot.py:426-604
    def get_uv_local(self):
        u, v = self._uv("local")
        return u, v, np.hypot(u, v)

    def get_uv_geographical(self):
        u, v = self._uv("geographical")
        return u, v, np.hypot(u, v)

    def get_uv_camera(self, dt: float = 0.1):
        u_loc, v_loc = self._uv("local")
        u, v = self._uv("camera")
        return u, v, np.hypot(u_loc, v_loc)

    def _finish(self, ax, p, add_colorbar, colorbar_loc, mode):
        if add_colorbar and p is not None:
            cbar(ax, p, loc=colorbar_loc)
        if mode == "local":
            ax.set_aspect("equal")
        return ax

    def quiver(self, mode="local", ax=None, add_colorbar=False, colorbar_loc=0, **kwargs):
        ax = self._mode_ax(mode, ax, kwargs)
        x, y, kind = self._coords(mode)
        u, v = self._uv(mode)
        s = np.hypot(u, v)
        if kind == "1d":
            x, y = np.meshgrid(x, y)
        if "color" in kwargs:
            p = ax.quiver(x, y, u, v, **kwargs)
        else:
            p = ax.quiver(x, y, u, v, s, **kwargs)
        return self._finish(ax, p, add_colorbar, colorbar_loc, mode)

    def pcolormesh(self, mode="local", ax=None, add_colorbar=False, colorbar_loc=0, **kwargs):
        ax = self._mode_ax(mode, ax, kwargs)
        x, y, kind = self._coords(mode)
        u, v = self._uv(mode)
        s = np.hypot(u, v)
        p = ax.pcolormesh(x, y, s, **kwargs)
        return self._finish(ax, p, add_colorbar, colorbar_loc, mode)

    def scatter(self, mode="local", ax=None, add_colorbar=False, colorbar_loc=0, **kwargs):
        ax = self._mode_ax(mode, ax, kwargs)
        x, y, kind = self._coords(mode)
        u, v = self._uv(mode)
        s = np.hypot(u, v)
        if kind == "1d":
            x, y = np.meshgrid(x, y)
        p = ax.scatter(x.ravel(), y.ravel(), c=s.ravel(), **kwargs)
        return self._finish(ax, p, add_colorbar, colorbar_loc, mode)

    def streamplot(
        self, mode="local", ax=None, add_colorbar=False, colorbar_loc=0, linewidth_scale=None, **kwargs
    ):
        if mode != "local":
            raise ValueError("streamplot only works in local mode")
        ax = _get_ax(ax)
        x, y, _ = self._coords(mode)
        u, v = self._uv(mode)
        if linewidth_scale is not None:
            kwargs["linewidth"] = np.hypot(u, v) * linewidth_scale
        # streamplot requires increasing y
        order = np.argsort(y)
        if linewidth_scale is not None:
            kwargs["linewidth"] = kwargs["linewidth"][order]
        p = ax.streamplot(x, y[order], u[order], v[order], **kwargs)
        if add_colorbar and hasattr(p, "lines"):
            cbar(ax, p.lines, loc=colorbar_loc)
        return ax


class _Transect_PlotMethods(_BasePlot):
    def __call__(self, method: str = "quiver", mode: str = "local", ax=None, **kwargs):
        return getattr(self, method)(mode=mode, ax=ax, **kwargs)

    # (u, v, s) accessors per projection, reference plot.py:363-469:
    # u = v_eff sin(v_dir), v = v_eff cos(v_dir); geographical rotates by the
    # grid transform's angle; camera projects displaced point pairs
    def _uv_eff(self):
        obj = self._obj
        if "v_eff" in obj:
            v_eff = obj["v_eff"].values
        else:
            if "v_eff_nofill" not in obj:
                obj.transect.vector_to_scalar()  # adds v_eff_nofill in place
            v_eff = obj["v_eff_nofill"].values
            if v_eff.ndim == 2:  # (time, points): reduce for plotting
                import warnings as _w

                with _w.catch_warnings():
                    _w.simplefilter("ignore", RuntimeWarning)
                    v_eff = np.nanmedian(v_eff, axis=0)
        u = v_eff * np.sin(obj["v_dir"].values)
        v = v_eff * np.cos(obj["v_dir"].values)
        return u, v, v_eff

    def get_uv_local(self):
        return self._uv_eff()

    def get_uv_geographical(self):
        u, v, s = self._uv_eff()
        aff = self.ref.camera_config.transform
        theta = np.arctan2(aff[1], aff[0])
        u, v = helpers.rotate_u_v(u, v, theta)
        return u, v, s

    def get_uv_camera(self, dt: float = 0.1):
        u, v, s = self._uv_eff()
        if u.ndim == 2:  # quantile dim: median row for displacement geometry
            u = u[u.shape[0] // 2]
            v = v[v.shape[0] // 2]
        cc = self.ref.camera_config
        x = self._obj["x"].values
        y = self._obj["y"].values
        z = cc.h_to_z(self.ref.h_a)
        cols0, rows0 = x / cc.resolution, cc.shape[0] - y / cc.resolution
        cols1, rows1 = (x + u * dt) / cc.resolution, cc.shape[0] - (y + v * dt) / cc.resolution
        xs0, ys0 = helpers.get_xs_ys(cols0, rows0, cc.transform)
        xs1, ys1 = helpers.get_xs_ys(cols1, rows1, cc.transform)
        p0 = cc.project_points(np.column_stack([xs0, ys0, np.full(x.shape, z)]), swap_y_coords=True)
        p1 = cc.project_points(np.column_stack([xs1, ys1, np.full(x.shape, z)]), swap_y_coords=True)
        return (p1[:, 0] - p0[:, 0]) / dt, (p1[:, 1] - p0[:, 1]) / dt, s

    def _points_uv(self, mode):
        obj = self._obj
        u = obj["v_eff" if "v_eff" in obj else "v_x"].values
        v_dir = obj["v_dir"].values
        if u.ndim == 2:  # quantile dim present: take median row
            u = u[u.shape[0] // 2]
        # decompose effective velocity along flow direction
        vx = u * np.sin(v_dir + 0.5 * np.pi)
        vy = u * np.cos(v_dir + 0.5 * np.pi)
        return vx, vy

    def _xy(self, mode):
        """Transect point coordinates in the plotting frame + image-space
        vectors for camera mode."""
        obj = self._obj
        x = obj["xcoords"].values
        y = obj["ycoords"].values
        vx, vy = self._points_uv(mode)
        if mode != "camera":
            return x, y, vx, vy, np.hypot(vx, vy)
        cc = self.ref.camera_config
        z = np.full(len(x), cc.get_z_a(self.ref.h_a))
        dt = 0.1
        p0 = cc.project_points(np.column_stack([x, y, z]), swap_y_coords=True)
        p1 = cc.project_points(np.column_stack([x + vx * dt, y + vy * dt, z]), swap_y_coords=True)
        u_c = (p1[:, 0] - p0[:, 0]) / dt
        v_c = (p1[:, 1] - p0[:, 1]) / dt
        sv = self._obj["v_eff" if "v_eff" in obj else "v_x"].values
        s = np.abs(sv[-1] if sv.ndim > 1 else sv)
        return p0[:, 0], p0[:, 1], u_c, v_c, s

    def _overlays(self, ax, mode, x, y, add_cross_section, add_text, text_prefix, text_suffix, kwargs_line):
        """Reference transect decorations (plot.py:160-240): cross-section
        line (local/geographical) or the camera-perspective wetted surface +
        water level + depth lines; optional discharge text."""
        import warnings as _w

        ref = self.ref
        if add_cross_section:
            if mode == "camera" and getattr(ref, "cross_section", None) is not None:
                try:
                    cs = ref.cross_section
                    h_a = ref.h_a
                    cs.plot(ax=ax, camera=True)
                    cs.plot_wetted_surface(h=h_a, camera=True, swap_y_coords=True, ax=ax)
                    z_a = ref.camera_config.h_to_z(h_a)
                    if cs.z.min() < z_a < cs.z.max():
                        try:
                            cs.plot_water_level(
                                h=h_a, length=2.0, linewidth=3.0, ax=ax, camera=True,
                                color="r", label="water level",
                            )
                        except Exception:
                            _w.warn(
                                "Not able to find a unique location for plotting of water level",
                                stacklevel=2,
                            )
                    for line in ref.get_depth_perspective(h=h_a):
                        arr = np.asarray(line)
                        ax.plot(arr[:, 0], arr[:, 1], color="w", alpha=0.5, linewidth=2.0, zorder=1)
                except Exception as e:
                    _w.warn(f"Camera-perspective cross-section overlay failed: {e}", stacklevel=2)
            elif mode != "camera":
                ax.plot(x, y, _LINE_COLOR, path_effects=_path_effects(),
                        alpha=0.7, **(kwargs_line or {}))
        if add_text:
            plot_text(ax, self._obj, text_prefix, text_suffix)

    def quiver(
        self, mode="local", ax=None, add_colorbar=False, colorbar_loc=0,
        add_cross_section=True, add_text=False, text_prefix="", text_suffix="",
        kwargs_line=None, **kwargs,
    ):
        ax = self._mode_ax(mode, ax, kwargs)
        x, y, vx, vy, s = self._xy(mode)
        if "color" in kwargs:
            p = ax.quiver(x, y, vx, vy, **kwargs)
        else:
            p = ax.quiver(x, y, vx, vy, s, **kwargs)
        self._overlays(ax, mode, x, y, add_cross_section, add_text, text_prefix, text_suffix, kwargs_line)
        if add_colorbar:
            cbar(ax, p, loc=colorbar_loc)
        return ax

    def scatter(
        self, mode="local", ax=None, add_colorbar=False, colorbar_loc=0,
        add_cross_section=True, add_text=False, text_prefix="", text_suffix="",
        kwargs_line=None, **kwargs,
    ):
        """Scatter of transect points colored by effective velocity
        (reference binds the shared scatter to transects, plot.py:847-849)."""
        ax = self._mode_ax(mode, ax, kwargs)
        x, y, vx, vy, s = self._xy(mode)
        p = ax.scatter(x, y, c=s, **kwargs)
        self._overlays(ax, mode, x, y, add_cross_section, add_text, text_prefix, text_suffix, kwargs_line)
        if add_colorbar:
            cbar(ax, p, loc=colorbar_loc)
        return ax
