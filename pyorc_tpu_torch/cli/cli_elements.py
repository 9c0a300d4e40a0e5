"""Interactive matplotlib selectors for GCPs, AOI corners and stabilization regions.

A copy of :mod:`pyorc_tpu.cli.cli_elements`, a functional port of the
reference's widget GUIs (reference ``pyorc/cli/cli_elements.py:33-535``):
click points on a video frame, with live reprojection feedback for GCPs.
Events are standard matplotlib mouse events, so tests can drive them
programmatically (as the reference tests do). Host code; matplotlib is
imported when a selector is made.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

__all__ = ["BaseSelect", "GcpSelect", "AoiSelect", "StabilizeSelect"]


class BaseSelect:
    """Shared point-clicking machinery on a background frame."""

    def __init__(self, img, dst=None, logger=None, max_points=None, title=""):
        import matplotlib.pyplot as plt

        self.logger = logger or logging.getLogger(__name__)
        self.img = img
        self.dst = dst
        self.src: List[List[float]] = []
        self.max_points = max_points
        fig, ax = plt.subplots(figsize=(12, 7))
        ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
        ax.set_title(title)
        self.fig = fig
        self.ax = ax
        (self.pts_plot,) = ax.plot([], [], "r+", markersize=12)
        self.cid_click = fig.canvas.mpl_connect("button_press_event", self.on_click)
        self.cid_key = fig.canvas.mpl_connect("key_press_event", self.on_key)
        self.done = False

    def on_click(self, event):
        if event.inaxes != self.ax or event.xdata is None:
            return
        if event.button == 1:
            if self.max_points is None or len(self.src) < self.max_points:
                self.src.append([float(event.xdata), float(event.ydata)])
                self.logger.debug(f"Point {len(self.src)}: ({event.xdata:.1f}, {event.ydata:.1f})")
        elif event.button == 3 and self.src:
            self.src.pop()
        self.redraw()
        if self.max_points is not None and len(self.src) == self.max_points:
            self.on_complete()

    def on_key(self, event):
        if event.key == "enter":
            self.on_complete()
        elif event.key == "escape":
            if self.src:
                self.src.pop()
                self.redraw()

    def redraw(self):
        pts = np.array(self.src) if self.src else np.zeros((0, 2))
        self.pts_plot.set_data(pts[:, 0], pts[:, 1])
        self.fig.canvas.draw_idle()

    def on_complete(self):
        self.done = True

    def run(self):
        import matplotlib.pyplot as plt

        plt.show(block=True)
        return self.src


class GcpSelect(BaseSelect):
    """Click ground control points; shows live optimized-pose reprojection."""

    def __init__(self, img, dst, crs=None, lens_position=None, camera_matrix=None, dist_coeffs=None, logger=None, **kwargs):
        super().__init__(
            img,
            dst=dst,
            logger=logger,
            max_points=len(dst),
            title=f"Click the {len(dst)} control points in the order of your destination list "
            "(right-click to undo, Enter to finish)",
        )
        self.crs = crs
        self.lens_position = lens_position
        self.camera_matrix = camera_matrix
        self.dist_coeffs = dist_coeffs
        (self.est_plot,) = self.ax.plot([], [], "co", markersize=8, fillstyle="none")
        self.camera_matrix_fit = None
        self.dist_coeffs_fit = None
        if crs is not None:
            self._add_geo_panel(kwargs.get("tiles", "GoogleTiles"), kwargs.get("zoom_level", 18))

    def _add_geo_panel(self, tiles, zoom_level):
        """Side panel with the destination points over a satellite basemap
        (reference BaseSelect's cartopy panel, cli_elements.py:33-235);
        degrades to a plain scatter when tiles are unavailable (offline)."""
        import warnings

        try:
            from ..geom import crs as crs_mod

            dst = np.asarray([d[:2] for d in self.dst], dtype=np.float64)
            lon, lat = crs_mod.transform_points(self.crs, 4326, dst[:, 0], dst[:, 1])
            pad_lon = max((lon.max() - lon.min()) * 0.5, 2e-4)
            pad_lat = max((lat.max() - lat.min()) * 0.5, 2e-4)
            extent = (lon.min() - pad_lon, lon.max() + pad_lon, lat.min() - pad_lat, lat.max() + pad_lat)
            self.ax.set_position([0.05, 0.1, 0.58, 0.8])
            self.ax_geo = self.fig.add_axes([0.68, 0.1, 0.28, 0.8])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # offline tile fallback
                from ..io import basemap

                basemap.add_basemap(self.ax_geo, extent, tiles=tiles, zoom_level=zoom_level)
            self.ax_geo.plot(lon, lat, "r+", markersize=10)
            for i, (lo, la) in enumerate(zip(lon, lat)):
                self.ax_geo.annotate(str(i + 1), (lo, la), color="r")
            self.ax_geo.set_title("control points")
            self.ax_geo.set_xlim(extent[0], extent[1])
            self.ax_geo.set_ylim(extent[2], extent[3])
        except Exception as e:
            self.logger.debug(f"No geographic panel: {e}")
            self.ax_geo = None

    def on_complete(self):
        """Fit intrinsics/pose on the clicked points and show reprojection."""
        from . import cli_utils

        if len(self.src) < min(4, len(self.dst)):
            return
        try:
            height, width = self.img.shape[:2]
            src_est, dst_est, camera_matrix, dist_coeffs, rvec, tvec, err = cli_utils.get_gcps_optimized_fit(
                self.src,
                self.dst,
                height,
                width,
                camera_matrix=self.camera_matrix,
                dist_coeffs=self.dist_coeffs,
                lens_position=self.lens_position,
            )
            self.camera_matrix_fit = np.asarray(camera_matrix)
            self.dist_coeffs_fit = np.asarray(dist_coeffs)
            src_est = np.asarray(src_est)
            self.est_plot.set_data(src_est[:, 0], src_est[:, 1])
            self.ax.set_title(f"Optimized fit, mean reprojection error {err if err is not None else 0:.3f} m")
            self.fig.canvas.draw_idle()
            self.logger.info(f"GCP fit complete, error: {err}")
        except Exception as e:
            self.logger.warning(f"Could not fit GCPs: {e}")
        self.done = True


class AoiSelect(BaseSelect):
    """Click 4 corner points of the area of interest.

    Live preview (reference cli_elements.py:236-359): once all 4 corners are
    clicked, the resulting orthorectification bounding box is drawn in the
    camera view (projected through the camera model) and — when the camera
    config carries a CRS — in a geographic side panel, so the user sees the
    exact AOI the pipeline will use before confirming.
    """

    def __init__(self, img, src=None, dst=None, camera_config=None, logger=None, **kwargs):
        super().__init__(
            img,
            logger=logger,
            max_points=4,
            title="Click 4 corner points: upstream-left, downstream-left, downstream-right, upstream-right",
        )
        self.camera_config = camera_config
        (self.bbox_plot,) = self.ax.plot([], [], "c-", linewidth=2, label="AOI bbox")
        self.ax_geo = None
        self.bbox_geo_plot = None
        if camera_config is not None and getattr(camera_config, "crs", None) is not None:
            self._add_geo_panel(kwargs.get("tiles", None), kwargs.get("zoom_level", 18))

    def _add_geo_panel(self, tiles, zoom_level):
        """Geographic side panel showing the AOI bbox over an optional basemap."""
        try:
            from ..geom import crs as crs_mod

            self.ax.set_position([0.05, 0.1, 0.58, 0.8])
            self.ax_geo = self.fig.add_axes([0.68, 0.1, 0.28, 0.8])
            self.ax_geo.set_title("AOI (geographic)")
            dst = np.asarray([d[:2] for d in self.camera_config.gcps["dst"]], dtype=np.float64)
            lon, lat = crs_mod.transform_points(self.camera_config.crs, 4326, dst[:, 0], dst[:, 1])
            pad_lon = max((lon.max() - lon.min()) * 0.5, 2e-4)
            pad_lat = max((lat.max() - lat.min()) * 0.5, 2e-4)
            extent = (lon.min() - pad_lon, lon.max() + pad_lon, lat.min() - pad_lat, lat.max() + pad_lat)
            if tiles is not None:
                import warnings

                from ..io import basemap

                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    basemap.add_basemap(self.ax_geo, extent, tiles=tiles, zoom_level=zoom_level)
            self.ax_geo.plot(lon, lat, "r+", markersize=8)
            self.ax_geo.set_xlim(extent[0], extent[1])
            self.ax_geo.set_ylim(extent[2], extent[3])
            (self.bbox_geo_plot,) = self.ax_geo.plot([], [], "c-", linewidth=2)
        except Exception as e:
            self.logger.debug(f"No geographic AOI panel: {e}")
            self.ax_geo = None

    def redraw(self):
        super().redraw()
        if len(self.src) == 4 and self.camera_config is not None:
            import copy

            try:
                cc = copy.deepcopy(self.camera_config)
                cc.set_bbox_from_corners(self.src)
                cam = np.asarray(cc.get_bbox(mode="camera", within_image=True).exterior.coords)
                self.bbox_plot.set_data(cam[:, 0], cam[:, 1])
                if self.ax_geo is not None and self.bbox_geo_plot is not None:
                    from ..geom import crs as crs_mod

                    geo = np.asarray(cc.get_bbox().exterior.coords)
                    lon, lat = crs_mod.transform_points(cc.crs, 4326, geo[:, 0], geo[:, 1])
                    self.bbox_geo_plot.set_data(lon, lat)
                    self.ax_geo.relim()
                    self.ax_geo.autoscale_view()
                self.fig.canvas.draw_idle()
            except Exception as e:
                self.logger.debug(f"AOI bbox preview failed: {e}")
        else:
            self.bbox_plot.set_data([], [])
            if self.bbox_geo_plot is not None:
                self.bbox_geo_plot.set_data([], [])


class StabilizeSelect(BaseSelect):
    """Click a polygon around the water area (outside is used for stabilization).

    The clicked region is rendered live as a translucent polygon (reference
    cli_elements.py:455-535): inside is the excluded water area, the rim
    outside feeds the stabilization feature tracker.
    """

    def __init__(self, img, logger=None, **kwargs):
        super().__init__(
            img,
            logger=logger,
            max_points=None,
            title="Click a polygon enclosing the moving water area (Enter to finish)",
        )
        from matplotlib.patches import Polygon as MplPolygon

        self.poly_patch = MplPolygon(
            np.zeros((0, 2)), closed=True, facecolor="c", edgecolor="c", alpha=0.3, visible=False
        )
        self.ax.add_patch(self.poly_patch)

    def redraw(self):
        super().redraw()
        if len(self.src) >= 3:
            self.poly_patch.set_xy(np.asarray(self.src))
            self.poly_patch.set_visible(True)
        else:
            self.poly_patch.set_visible(False)
        self.fig.canvas.draw_idle()
