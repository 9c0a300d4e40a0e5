"""CrossSection: bathymetry geometry + optical water-level detection.

Port of :mod:`pyorc_tpu.api.cross_section` (itself a port of the reference's
``pyorc/api/cross_section.py:156-1797``), host float64 numpy on the port's
copy of the geometry stack: 3-D
cross-section coordinates with s/l/d parameterizations, waterline crossing
points/lines/polygons, planar/wetted/bottom surfaces in world or camera
perspective, bbox construction, and optical water-level detection by
comparing pixel-intensity histograms on either side of hypothesized
waterlines (grid-scan with s2n quality metric, or differential evolution).
The candidate scoring of the grid scans runs on the device
(:func:`pyorc_tpu_torch.ops.waterlevel.polygon_histogram_scores`); polygon
pixels are rasterized without OpenCV (:func:`pyorc_tpu_torch.geom.shapes.fill_polygon`).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np

from ..geom import aoi as aoi_mod
from ..geom import shapes
from .cameraconfig import CameraConfig

BANK_OPTIONS = {"far", "near", "both"}

__all__ = ["CrossSection"]


def _fit_line(x, y):
    """PCA line fit -> (centroid, direction, angle). Reference cross_section.py:41-69."""
    ps = np.column_stack([x, y])
    centr = ps.mean(axis=0)
    _, _, vh = np.linalg.svd(ps - centr)
    direc = vh[0]
    ang = np.arctan2(direc[1], direc[0])
    return centr, direc, ang


def _make_angle_lines(csl_points, angle_perp, length, offset):
    """Perpendicular lines at points. Reference cross_section.py:72-86."""
    pts = [
        shapes.translate(p, xoff=np.cos(angle_perp) * offset, yoff=np.sin(angle_perp) * offset)
        for p in csl_points
    ]
    lines = [
        shapes.LineString([(p.x - length / 2, p.y), (p.x + length / 2, p.y)]) for p in pts
    ]
    return [shapes.rotate(l, angle_perp, origin=(p.x, p.y), use_radians=True) for l, p in zip(lines, pts)]


def _histogram(data, bin_size: int = 5, normalize=False):
    """Histogram with fixed bin size. Reference cross_section.py:89-108."""
    bin_size = int(bin_size)
    if not data.dtype == np.uint8:
        raise ValueError("Image data must be of type uint8.")
    if not (bin_size >= 5 and bin_size <= 20):
        raise ValueError("Bin size must be between 5 and 20")
    bins = np.arange(0, 256, bin_size)
    counts, edges = np.histogram(data, bins=bins)
    if normalize and np.sum(counts) > 0:
        bin_widths = np.diff(edges)
        counts = counts / (np.sum(counts) * bin_widths)
    centers = (edges[:-1] + edges[1:]) / 2
    return centers, edges, counts


def _histogram_union(edges, hist1, hist2):
    """Dissimilarity score of two normalized histograms in [0, 2]. Reference :111-122."""
    bin_chunks = edges[1:] - edges[:-1]
    hist_max = np.maximum(hist1, hist2)
    union = (bin_chunks * hist_max).sum()
    return 2 - union


def _find_infinite_intersection(line1, line2):
    """Intersection of two infinite lines. Reference cross_section.py:125-153."""
    x1, y1 = line1.coords[0][:2]
    x2, y2 = line1.coords[1][:2]
    x3, y3 = line2.coords[0][:2]
    x4, y4 = line2.coords[1][:2]
    a1, b1 = y2 - y1, x1 - x2
    c1 = a1 * x1 + b1 * y1
    a2, b2 = y4 - y3, x3 - x4
    c2 = a2 * x3 + b2 * y3
    det = a1 * b2 - a2 * b1
    if det == 0:
        return None
    return shapes.Point((b2 * c1 - b1 * c2) / det, (a1 * c2 - a2 * c1) / det)


def get_polygon_pixels(img: np.ndarray, polygon: shapes.Polygon) -> np.ndarray:
    """Extract image pixel values inside a polygon (camera coordinates).

    Replaces the reference's numba pixel extraction (reference
    ``pyorc/cv.py:1047-1083``) with a bounded polygon mask + gather; the
    mask is ``cv2.fillPoly``'s, drawn by :func:`shapes.fill_polygon`.
    """
    ring = np.asarray(polygon.exterior.coords, dtype=np.float64)[:, :2]
    ring = ring[np.isfinite(ring).all(axis=1)]
    if len(ring) < 3:
        return np.array([], dtype=img.dtype)
    h, w = img.shape[:2]
    minx = int(np.clip(np.floor(ring[:, 0].min()), 0, w - 1))
    maxx = int(np.clip(np.ceil(ring[:, 0].max()), 0, w - 1))
    miny = int(np.clip(np.floor(ring[:, 1].min()), 0, h - 1))
    maxy = int(np.clip(np.ceil(ring[:, 1].max()), 0, h - 1))
    if maxx <= minx or maxy <= miny:
        return np.array([], dtype=img.dtype)
    sub = img[miny : maxy + 1, minx : maxx + 1]
    mask = shapes.fill_polygon(sub.shape[:2], np.round(ring - [minx, miny]).astype(np.int32))
    return sub[mask]


class CrossSection:
    """3-D cross-section geometry with optical water-level functionality."""

    def __init__(self, camera_config: CameraConfig, cross_section):
        if hasattr(cross_section, "geometry"):  # GeoDataFrame-like
            g = cross_section.geometry
            x, y, z = list(g.x.values), list(g.y.values), list(g.z.values)
        else:
            x, y, z = list(map(list, zip(*cross_section)))
        x_diff = np.concatenate((np.array([0]), np.diff(x)))
        y_diff = np.concatenate((np.array([0]), np.diff(y)))
        z_diff = np.concatenate((np.array([0]), np.diff(z)))
        s = np.cumsum((x_diff**2 + y_diff**2) ** 0.5)
        lens_position_xy = camera_config.estimate_lens_position()[0:2]
        d = ((np.array(x) - lens_position_xy[0]) ** 2 + (np.array(y) - lens_position_xy[1]) ** 2) ** 0.5
        l = np.cumsum(np.sqrt(x_diff**2 + y_diff**2 + z_diff**2))
        self.x = np.array(x)
        self.y = np.array(y)
        self.z = np.array(z)
        self.s = s
        self.l = l
        self.d = d
        self.camera_config = camera_config

    def __str__(self):
        return str(self.cs_linestring)

    def __repr__(self):
        return str(self.cs_linestring)

    # -- interpolators ------------------------------------------------------------

    def _interp(self, xp, fp):
        from scipy.interpolate import interp1d

        return interp1d(xp, fp, kind="linear", fill_value="extrapolate")

    @property
    def interp_x(self):
        return self._interp(self.l, self.x)

    @property
    def interp_y(self):
        return self._interp(self.l, self.y)

    @property
    def interp_z(self):
        return self._interp(self.l, self.z)

    @property
    def interp_d(self):
        return self._interp(self.l, self.d)

    @property
    def interp_x_from_s(self):
        return self._interp(self.s, self.x)

    @property
    def interp_y_from_s(self):
        return self._interp(self.s, self.y)

    @property
    def interp_z_from_s(self):
        return self._interp(self.s, self.z)

    @property
    def interp_s_from_l(self):
        return self._interp(self.l, self.s)

    # -- geometry ------------------------------------------------------------

    @property
    def cs_points(self) -> List[shapes.Point]:
        return [shapes.Point(_x, _y, _z) for _x, _y, _z in zip(self.x, self.y, self.z)]

    @property
    def cs_points_sz(self) -> List[shapes.Point]:
        return [shapes.Point(_s, _z) for _s, _z in zip(self.s, self.z)]

    @property
    def cs_linestring(self) -> shapes.LineString:
        return shapes.LineString(np.column_stack([self.x, self.y, self.z]))

    @property
    def cs_linestring_sz(self) -> shapes.LineString:
        return shapes.LineString(np.column_stack([self.s, self.z]))

    @property
    def cs_angle(self) -> float:
        diff_xy = np.array([self.x[-1] - self.x[0], self.y[-1] - self.y[0]])
        return float(np.arctan2(diff_xy[1], diff_xy[0]))

    @property
    def distance_camera(self) -> float:
        coord_mean = np.array([self.x.mean(), self.y.mean(), self.z.mean()])
        return float(np.sum((self.camera_config.estimate_lens_position() - coord_mean) ** 2) ** 0.5)

    @property
    def idx_closest_point(self) -> int:
        return 0 if self.d[0] < self.d[-1] else len(self.d) - 1

    @property
    def idx_farthest_point(self) -> int:
        return 0 if self.d[0] > self.d[-1] else len(self.d) - 1

    @property
    def within_image(self) -> bool:
        pix = self.camera_config.project_points(np.column_stack([self.x, self.y, self.z]), within_image=True)
        within = np.all(
            [
                pix[:, 0] >= 0,
                pix[:, 0] < self.camera_config.width,
                pix[:, 1] >= 0,
                pix[:, 1] < self.camera_config.height,
            ],
            axis=0,
        )
        return bool(np.any(within))

    # -- waterlines ------------------------------------------------------------

    def get_cs_waterlevel(self, h: float, sz: bool = False, extend_by: Optional[float] = None) -> shapes.LineString:
        """Waterline at level h (sz: s-z projection). Reference :347-393."""
        z = self.camera_config.h_to_z(h)
        if sz:
            if extend_by is None:
                s_coords = self.s
            else:
                s_coords = np.concatenate([[-np.abs(extend_by)], self.s, [self.s[-1] + np.abs(extend_by)]])
            return shapes.LineString(np.column_stack([s_coords, np.full(len(s_coords), z)]))
        if extend_by is not None:
            alpha = np.arctan((self.x[1] - self.x[0]) / (self.y[1] - self.y[0]))
            x_coords = np.concatenate(
                [[self.x[0] - np.cos(alpha) * np.abs(extend_by)], self.x, [self.x[-1] + np.cos(alpha) * np.abs(extend_by)]]
            )
            y_coords = np.concatenate(
                [[self.y[0] - np.sin(alpha) * np.abs(extend_by)], self.y, [self.y[-1] + np.sin(alpha) * np.abs(extend_by)]]
            )
        else:
            x_coords, y_coords = self.x, self.y
        return shapes.LineString(np.column_stack([x_coords, y_coords, np.full(len(x_coords), z)]))

    def get_csl_point(self, h=None, l=None, camera=False, swap_y_coords=False) -> List[shapes.Point]:
        """Points where the waterline touches land. Reference :395-461."""
        if h is not None and l is not None:
            raise ValueError("Only one of h or l can be provided.")
        if h is None and l is None:
            raise ValueError("One of h or l must be provided.")
        if l is not None:
            if l < 0 or l > self.l[-1]:
                raise ValueError("Value of l is outside the cross section range")
            cross = [shapes.Point(float(self.interp_x(l)), float(self.interp_y(l)), float(self.interp_z(l)))]
        else:
            z = self.camera_config.h_to_z(h)
            if z > self.z.max() or z < self.z.min():
                raise ValueError("Water level is outside the cross-section elevation range")
            cs_waterlevel = self.get_cs_waterlevel(h, sz=True)
            cross_sz = cs_waterlevel.intersection(self.cs_linestring_sz)
            if isinstance(cross_sz, shapes.Point):
                cross_sz = [cross_sz]
            elif hasattr(cross_sz, "geoms"):
                cross_sz = list(cross_sz.geoms)
            else:
                raise ValueError("Cross section is not crossed by water level.")
            if len(cross_sz) == 0:
                raise ValueError("Cross section is not crossed by water level.")
            cross_sz = sorted(cross_sz, key=lambda p: p.x)
            cross = [
                shapes.Point(
                    float(self.interp_x_from_s(c.x)), float(self.interp_y_from_s(c.x)), float(c.y)
                )
                for c in cross_sz
            ]
        if camera:
            coords = [[p.x, p.y, p.z] for p in cross]
            coords_proj = self.camera_config.project_points(coords, swap_y_coords=swap_y_coords)
            cross = [shapes.Point(p[0], p[1]) for p in coords_proj]
        return cross

    def get_csl_line(self, h=None, l=None, length=0.5, offset=0.0, camera=False, swap_y_coords=False):
        """Waterlines perpendicular to the cross-section. Reference :463-519."""
        csl_points = self.get_csl_point(h=h, l=l)
        z = csl_points[0].z
        angle_perp = self.cs_angle + np.pi / 2
        csl_lines = _make_angle_lines(csl_points, angle_perp, length, offset)
        if camera:
            coords_lines = [[[_x, _y, z] for _x, _y in np.asarray(l_._coords)[:, :2]] for l_ in csl_lines]
            coords_proj = [
                self.camera_config.project_points(cl, swap_y_coords=swap_y_coords) for cl in coords_lines
            ]
            return [shapes.LineString(np.asarray(c)) for c in coords_proj]
        return [
            shapes.LineString(np.column_stack([np.asarray(l_._coords)[:, 0], np.asarray(l_._coords)[:, 1], np.full(len(l_._coords), z)]))
            for l_ in csl_lines
        ]

    def get_csl_pol(
        self, h=None, l=None, length=0.5, padding=(-0.5, 0.5), offset=0.0, camera=False, swap_y_coords=False
    ) -> List[shapes.Polygon]:
        """Padded polygons around waterlines. Reference :521-594."""
        csl = self.get_csl_line(h=h, l=l, length=length, offset=offset)
        if len(padding) != 2:
            raise ValueError(f"padding must contain two values (provided: {len(padding)})")
        if padding[1] <= padding[0]:
            raise ValueError("First value of padding must be smaller than second")
        csl_pol_bounds = [
            [
                shapes.translate(line, xoff=np.cos(self.cs_angle) * padding[0], yoff=np.sin(self.cs_angle) * padding[0]),
                shapes.translate(line, xoff=np.cos(self.cs_angle) * padding[1], yoff=np.sin(self.cs_angle) * padding[1]),
            ]
            for line in csl
        ]
        csl_pol_coords = [
            np.concatenate([l0._coords, l1._coords[::-1], l0._coords[:1]], axis=0) for l0, l1 in csl_pol_bounds
        ]
        if camera:
            out = []
            for coords in csl_pol_coords:
                coords_expand = np.zeros((0, coords.shape[1]))
                for n in range(0, len(coords) - 1):
                    new_coords = np.linspace(coords[n], coords[n + 1], 100)
                    coords_expand = np.r_[coords_expand, new_coords]
                proj = self.camera_config.project_points(coords_expand, swap_y_coords=swap_y_coords, within_image=True)
                proj = proj[np.isfinite(proj[:, 0])]
                out.append(proj)
            csl_pol_coords = out
        return [shapes.Polygon(coords) for coords in csl_pol_coords]

    def get_bbox(self, h: float, length: float = 2.0, offset: float = 0.0) -> shapes.Polygon:
        """Bounding box for the camera config from the cross-section. Reference :596-651."""
        csl = self.get_csl_line(h=h, length=length, offset=offset, camera=False)
        if len(csl) < 2:
            raise ValueError("Bounding box cannot be created: water line does not cross land at least twice.")
        line1 = shapes.LineString(np.asarray(csl[0]._coords)[:, :2])
        line2 = shapes.LineString(np.asarray(csl[-1]._coords)[:, :2])
        diff_coord = (
            np.array([line1.centroid.x, line1.centroid.y]) - np.array([line2.centroid.x, line2.centroid.y])
        ) / 2
        line_middle = shapes.translate(line2, xoff=diff_coord[0], yoff=diff_coord[1])
        fact = length / line_middle.length
        line_middle = shapes.scale(line_middle, xfact=fact, yfact=fact)
        line_cross = shapes.rotate(line_middle, 90, origin="centroid")
        p_cross1 = _find_infinite_intersection(line1, line_cross)
        p_cross2 = _find_infinite_intersection(line2, line_cross)
        p_length = shapes.Point(*line_middle.coords[0][:2])
        dst_corners = [
            [p_cross1.x, p_cross1.y],
            [p_cross2.x, p_cross2.y],
            [p_length.x, p_length.y],
        ]
        return aoi_mod.get_aoi(dst_corners, resolution=None, method="width_length")

    # -- surfaces ------------------------------------------------------------

    def get_planar_surface(self, h, length=2.0, offset=0.0, camera=False, swap_y_coords=False):
        """Planar water-surface polygon(s). Reference :787-859."""
        csl_points = self.get_csl_point(h=h, camera=False)
        if len(csl_points) < 2:
            raise ValueError(
                f"Cross section must have at least two crossing points for a planar surface ({len(csl_points)} found)."
            )
        wls = self.get_csl_line(h=h, offset=offset, length=length, camera=camera, swap_y_coords=swap_y_coords)
        valid_pairs = []
        for p1, p2, l1, l2 in zip(csl_points[:-1], csl_points[1:], wls[:-1], wls[1:]):
            s1 = self.cs_linestring.project(shapes.Point(p1.x, p1.y))
            s2 = self.cs_linestring.project(shapes.Point(p2.x, p2.y))
            s_mid = (s1 + s2) / 2
            if float(self.interp_z_from_s(s_mid)) < p1.z:
                valid_pairs.append((l1, l2))
        if len(valid_pairs) == 0:
            raise ValueError("No valid water level crossings found.")
        polygons = []
        for l1, l2 in valid_pairs:
            pol = shapes.Polygon(np.concatenate([l1._coords, l2._coords[::-1]], axis=0))
            if pol.is_valid and not pol.is_empty:
                polygons.append(pol)
        if len(polygons) == 0:
            raise ValueError("No valid polygons found.")
        if len(polygons) == 1:
            return polygons[0]
        return shapes.MultiPolygon(polygons)

    def get_bottom_surface(self, length=2.0, offset=0.0, camera=False, swap_y_coords=False) -> shapes.Polygon:
        """Bottom surface polygon expanded over a length. Reference :728-785."""
        csl_points = [self.cs_points[0], self.cs_points[-1]]
        angle_perp = self.cs_angle + np.pi / 2
        csl_lines = _make_angle_lines(csl_points, angle_perp, length, offset)
        csl_line_points = [
            np.column_stack([np.asarray(l_._coords)[:, 0], np.asarray(l_._coords)[:, 1], np.full(len(l_._coords), z)])
            for l_, z in zip(csl_lines, [self.cs_points[0].z, self.cs_points[-1].z])
        ]
        csl_displaced = [
            np.column_stack(
                [
                    self.x + np.cos(angle_perp) * (offset + ll),
                    self.y + np.sin(angle_perp) * (offset + ll),
                    self.z,
                ]
            )
            for ll in [length / 2, -length / 2]
        ]
        all_points = np.concatenate(
            [csl_line_points[0], csl_displaced[0], csl_line_points[1][::-1], csl_displaced[1][::-1]], axis=0
        )
        if camera:
            proj = self.camera_config.project_points(all_points, swap_y_coords=swap_y_coords, within_image=True)
            proj = proj[np.isfinite(proj[:, 0])]
            return shapes.Polygon(proj)
        return shapes.Polygon(all_points)

    def get_wetted_surface_sz(self, h: float, perimeter: bool = False):
        """Wetted surface (or perimeter) in the s-z plane. Reference :864-931.

        Implemented directly from waterline/profile crossings rather than via
        generic polygonize: wetted polygons are the profile spans below the
        waterline between consecutive crossings.
        """
        z = self.camera_config.h_to_z(h)
        # build the bottom polyline, extended slightly above water at the ends
        pts = list(np.column_stack([self.s, self.z]))
        if pts[0][1] < z:
            pts.insert(0, np.array([pts[0][0], z + 0.1]))
        if pts[-1][1] < z:
            pts.append(np.array([pts[-1][0], z + 0.1]))
        pts = np.asarray(pts)
        # find crossings of profile with level z and split into below-water runs
        segments: List[np.ndarray] = []
        current: List[np.ndarray] = []
        for i in range(len(pts) - 1):
            p0, p1 = pts[i], pts[i + 1]
            below0 = p0[1] < z
            below1 = p1[1] < z
            if below0:
                if not current:
                    current.append(p0)
            if below0 != below1 and p1[1] != p0[1]:
                t = (z - p0[1]) / (p1[1] - p0[1])
                crossing = p0 + t * (p1 - p0)
                if below0:  # going up through z: close the run
                    current.append(crossing)
                    segments.append(np.asarray(current))
                    current = []
                else:  # going down through z: open a run
                    current = [crossing]
            elif below0 and below1:
                current.append(p1)
        if current:
            segments.append(np.asarray(current))
        if perimeter:
            return shapes.MultiLineString([shapes.LineString(seg) for seg in segments if len(seg) >= 2])
        pols = []
        for seg in segments:
            if len(seg) >= 2:
                ring = np.concatenate([seg, seg[:1] * 0 + [seg[-1][0], z], seg[:1] * 0 + [seg[0][0], z]], axis=0)
                # close along the waterline: seg runs along the bottom; top edge at z
                ring = np.concatenate([seg, [[seg[-1][0], z], [seg[0][0], z]]], axis=0)
                pol = shapes.Polygon(ring)
                if pol.area > 0:
                    pols.append(pol)
        if not pols:
            lowest_z = self.z.min()
            lowest_s = self.s[list(self.z).index(lowest_z)]
            pols = [shapes.Polygon([(lowest_s, lowest_z)] * 3)]
        return shapes.MultiPolygon(pols)

    def get_wetted_surface(self, h: float, camera: bool = False, swap_y_coords=False) -> shapes.MultiPolygon:
        """Wetted surface in world (or camera) coordinates. Reference :933-962."""
        pols = self.get_wetted_surface_sz(h=h)
        pols_proj = []
        for pol in pols.geoms:
            coords = np.array(
                [
                    [float(self.interp_x_from_s(p[0])), float(self.interp_y_from_s(p[0])), p[1]]
                    for p in pol.exterior.coords
                ]
            )
            if camera:
                proj = self.camera_config.project_points(coords, swap_y_coords=swap_y_coords)
                pols_proj.append(shapes.Polygon(proj))
            else:
                pols_proj.append(shapes.Polygon(coords))
        return shapes.MultiPolygon(pols_proj)

    def get_bbox_dry_wet(self, h, camera=False, swap_y_coords=False, dry=False, expand_exterior=True, exterior_split=100):
        """Wet (or dry) part of the camera-config bbox. Reference :653-726."""
        if self.camera_config.bbox is None:
            raise ValueError("CameraConfig must have a bounding box to use this method.")
        z_water = self.camera_config.h_to_z(h)
        geom_plan_2d = shapes.force_2d(self.get_planar_surface(h=h, length=10000))
        if dry:
            pols = shapes.force_3d(
                self.camera_config.bbox.difference(geom_plan_2d, resolution=self.camera_config.resolution),
                z=z_water,
            )
        else:
            pols = shapes.force_3d(self.camera_config.bbox.intersection(geom_plan_2d), z=z_water)
        pols = list(pols.geoms) if isinstance(pols, shapes.MultiPolygon) else [pols]
        pols_proj = []
        for pol in pols:
            coords = np.asarray([[*p] for p in pol.exterior.coords])
            if camera and len(coords) > 0:
                if expand_exterior:
                    coords_expand = np.zeros((0, coords.shape[1]))
                    for n in range(0, len(coords) - 1):
                        new_coords = np.linspace(coords[n], coords[n + 1], exterior_split // 4)
                        coords_expand = np.r_[coords_expand, new_coords]
                    coords = coords_expand
                proj = self.camera_config.project_points(coords, swap_y_coords=swap_y_coords, within_image=True)
                pols_proj.append(shapes.Polygon(proj[np.isfinite(proj[:, 0])]))
            else:
                pols_proj.append(shapes.Polygon(coords))
        return shapes.MultiPolygon(pols_proj)

    # -- transforms ------------------------------------------------------------

    def rotate_translate(self, angle=None, xoff=0.0, yoff=0.0, zoff=0.0) -> "CrossSection":
        """Rotate/translate the cross-section. Reference :1379-1415."""
        xy = np.column_stack([self.x, self.y])
        if angle is not None:
            c = self.cs_linestring.centroid
            origin = np.array([c.x, c.y])
            ca, sa = np.cos(angle), np.sin(angle)
            R = np.array([[ca, -sa], [sa, ca]])
            xy = (xy - origin) @ R.T + origin
        xy = xy + np.array([xoff, yoff])
        coords = [[float(px), float(py), float(pz + zoff)] for (px, py), pz in zip(xy, self.z)]
        return CrossSection(self.camera_config, coords)

    def linearize(self) -> "CrossSection":
        """Snap points onto a PCA best-fit straight line. Reference :1417-1444."""
        centroid, direction, _ = _fit_line(self.x, self.y)
        coords = np.column_stack([self.x, self.y]) - centroid
        projections = coords @ direction
        new_x = centroid[0] + projections * direction[0]
        new_y = centroid[1] + projections * direction[1]
        return CrossSection(self.camera_config, [[float(a), float(b), float(c)] for a, b, c in zip(new_x, new_y, self.z)])

    # -- optical water level ------------------------------------------------------------

    def get_line_of_interest(self, bank: str = "far") -> Tuple[float, float]:
        """l-range to scan for water level detection. Reference :964-998."""
        if bank == "both":
            return self.l.min(), self.l.max()
        elif bank == "far":
            start_point = self.l[self.idx_farthest_point]
        elif bank == "near":
            start_point = self.l[self.idx_closest_point]
        else:
            raise ValueError(f"bank must be one of {BANK_OPTIONS}, not {bank}")
        l_lowest = self.l[np.where(self.z == self.z.min())]
        end_point = l_lowest[np.argmin(np.abs(l_lowest - start_point))]
        return tuple(np.sort(np.array([start_point, end_point])))

    def get_histogram_score(
        self, x, img, bin_size=5.0, offset=0.0, padding=0.5, length=2.0, min_z=None, max_z=None, min_samples=50
    ):
        """Histogram dissimilarity score at position l. Reference :1001-1032."""
        l = x[0]
        if min_z is not None and float(self.interp_z(l)) < min_z:
            return 2.0 + np.abs(float(self.interp_z(l)) - min_z)
        if max_z is not None and float(self.interp_z(l)) > max_z:
            return 2.0 + np.abs(float(self.interp_z(l)) - max_z)
        pol1 = self.get_csl_pol(l=l, offset=offset, padding=(0, padding), length=length, camera=True)[0]
        pol2 = self.get_csl_pol(l=l, offset=offset, padding=(-padding, 0), length=length, camera=True)[0]
        ints1 = get_polygon_pixels(img, pol1)
        ints2 = get_polygon_pixels(img, pol2)
        if ints1.size < min_samples or ints2.size < min_samples:
            return 2.0
        _, _, norm_counts1 = _histogram(ints1, normalize=True, bin_size=bin_size)
        _, bin_edges, norm_counts2 = _histogram(ints2, normalize=True, bin_size=bin_size)
        return _histogram_union(bin_edges, norm_counts1, norm_counts2)

    def _preprocess_level_range(self, min_h=None, max_h=None, min_z=None, max_z=None):
        if min_z is None and min_h is not None:
            min_z = np.maximum(self.camera_config.h_to_z(min_h), self.z.min())
        if max_z is None and max_h is not None:
            max_z = np.minimum(self.camera_config.h_to_z(max_h), self.z.max())
        if min_z and max_z and min_z > max_z:
            raise ValueError("Minimum water level is higher than maximum water level.")
        return min_z, max_z

    def _preprocess_l_range(self, l_min, l_max, ds_max=0.5, dz_max=0.02):
        """Evaluation points between l_min and l_max. Reference :1468-1532."""
        current_l = l_min
        last_z = None
        last_s = None
        valid = (self.l >= l_min) & (self.l <= l_max)
        l_range = list(self.l[valid])
        z_range = list(self.z[valid])
        while current_l <= l_max:
            z = float(self.interp_z(current_l))
            s = float(self.interp_s_from_l(current_l))
            if last_z is None or last_s is None or abs(z - last_z) >= dz_max or abs(s - last_s) >= ds_max:
                l_range.append(current_l)
                z_range.append(z)
                last_z = z
                last_s = s
            current_l += 0.01
        if current_l > l_max:
            l_range.append(l_max)
            z_range.append(float(self.interp_z(l_max)))
        order = np.argsort(l_range)
        return np.array(l_range)[order], np.array(z_range)[order]

    def _water_level_score_range(
        self,
        img,
        bank="far",
        bin_size=5,
        length=2.0,
        padding=0.5,
        offset=0.0,
        ds_max=0.5,
        dz_max=0.02,
        min_h=None,
        max_h=None,
        min_z=None,
        max_z=None,
    ):
        """Score all candidate waterline positions. Reference :1534-1620."""
        l_min, l_max = self.get_line_of_interest(bank=bank)
        min_z, max_z = self._preprocess_level_range(min_h, max_h, min_z, max_z)
        l_range, z_range = self._preprocess_l_range(l_min=l_min, l_max=l_max, ds_max=ds_max, dz_max=dz_max)
        img = self._gray_uint8(img)
        results = self._scores_batched(
            img, l_range, bin_size=bin_size, offset=offset, padding=padding, length=length,
            min_z=min_z, max_z=max_z,
        )
        return l_range, z_range, list(results)

    def _gray_uint8(self, img) -> np.ndarray:
        """``img`` as the uint8 gray frame the scorers read (bands averaged); raises on a wrong shape."""
        if len(img.shape) == 3:
            img = img.mean(axis=2)
        if img.shape[0] != self.camera_config.height:
            raise ValueError(f"Image height {img.shape[0]} != camera_config height {self.camera_config.height}")
        if img.shape[1] != self.camera_config.width:
            raise ValueError(f"Image width {img.shape[1]} != camera_config width {self.camera_config.width}")
        return img.astype(np.uint8) if img.dtype != np.uint8 else img

    def _scores_batched(
        self, img, l_values, bin_size=5, offset=0.0, padding=0.5, length=2.0,
        min_z=None, max_z=None, min_samples=50,
    ) -> np.ndarray:
        """Histogram scores for ALL candidate waterline positions in one
        device call: polygon geometry stays host-side, the
        rasterize+histogram work batches through
        :func:`pyorc_tpu_torch.ops.waterlevel.polygon_histogram_scores`."""
        from ..ops import waterlevel

        l_values = np.asarray(l_values, dtype=np.float64)
        pols1, pols2, keep = [], [], []
        penalties = np.zeros(len(l_values), np.float64)
        for i, l in enumerate(l_values):
            zl = float(self.interp_z(l))
            if min_z is not None and zl < min_z:
                penalties[i] = 2.0 + abs(zl - min_z)
                continue
            if max_z is not None and zl > max_z:
                penalties[i] = 2.0 + abs(zl - max_z)
                continue
            pols1.append(np.asarray(
                self.get_csl_pol(l=l, offset=offset, padding=(0, padding), length=length, camera=True)[0].exterior.coords
            ))
            pols2.append(np.asarray(
                self.get_csl_pol(l=l, offset=offset, padding=(-padding, 0), length=length, camera=True)[0].exterior.coords
            ))
            keep.append(i)
        out = penalties
        if keep:
            scores = waterlevel.polygon_histogram_scores(
                img, pols1, pols2, bin_size=bin_size, min_samples=min_samples
            )
            out[np.asarray(keep)] = scores
        return out

    def detect_water_level(
        self, img, bank="far", bin_size=5, length=2.0, padding=0.5, offset=0.0,
        min_h=None, max_h=None, min_z=None, max_z=None, method="grid",
    ) -> float:
        """Water level by optimization over waterline position. Reference :1622-1707.

        ``method="grid"`` (default) scores a dense candidate grid in ONE
        batched device call (finer than the reference DE's 0.01 atol);
        ``method="de"`` keeps the reference's scipy differential evolution
        over per-candidate host scores.
        """
        l_min, l_max = self.get_line_of_interest(bank=bank)
        min_z, max_z = self._preprocess_level_range(min_h, max_h, min_z, max_z)
        img = self._gray_uint8(img)
        if method == "grid":
            # 5 mm step, capped at ~500 candidates (crop batches scale with
            # the candidate count; the reference DE's atol was 0.01 anyway);
            # linspace keeps every candidate inside [l_min, l_max] — an
            # arange endpoint can overshoot l_max and fail polygon lookup
            n_cand = int(np.clip(round((l_max - l_min) / 5e-3) + 1, 2, 501))
            l_cand = np.linspace(l_min, l_max, n_cand)
            scores = self._scores_batched(
                img, l_cand, bin_size=bin_size, offset=offset, padding=padding,
                length=length, min_z=min_z, max_z=max_z,
            )
            best = np.array([float(l_cand[int(np.argmin(scores))])])
        else:
            from scipy.optimize import differential_evolution

            opt = differential_evolution(
                self.get_histogram_score,
                popsize=50,
                bounds=[(l_min, l_max)],
                args=(img, bin_size, offset, padding, length, min_z, max_z),
                atol=0.01,
            )
            best = opt.x
        z = float(self.interp_z(best[0]))
        h = self.camera_config.z_to_h(z)
        if np.isclose(best[0], l_min) or np.isclose(best[0], l_max):
            warnings.warn(
                f"The detected water level is on the edge of the search space and may be wrong. "
                f"Water level is {h} m. at cross-section length {best[0]}.",
                UserWarning,
                stacklevel=2,
            )
        return h

    def detect_water_level_s2n(
        self, img, bank="far", bin_size=5, length=2.0, padding=0.5, offset=0.0,
        ds_max=0.5, dz_max=0.02, min_h=None, max_h=None, min_z=None, max_z=None,
    ) -> Tuple[float, float]:
        """Water level by grid scan + signal-to-noise quality. Reference :1709-1797."""
        l_range, z_range, results = self._water_level_score_range(
            img=img, bank=bank, bin_size=bin_size, length=length, padding=padding, offset=offset,
            ds_max=ds_max, dz_max=dz_max, min_h=min_h, max_h=max_h, min_z=min_z, max_z=max_z,
        )
        idx = int(np.argmin(results))
        s2n = float(np.mean(results) / results[idx])
        z = z_range[idx]
        h = self.camera_config.z_to_h(z)
        return h, s2n

    # -- plotting ------------------------------------------------------------

    def plot(self, h: Optional[float] = None, ax=None, camera: bool = False, **kwargs):
        """Plot the cross-section profile (s-z) or its camera projection."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        if camera:
            pix = self.camera_config.project_points(
                np.column_stack([self.x, self.y, self.z]), within_image=True, swap_y_coords=True
            )
            ax.plot(pix[:, 0], pix[:, 1], **({"color": "#385895"} | kwargs))
        else:
            ax.plot(self.s, self.z, **({"color": "#385895"} | kwargs))
            if h is not None:
                z = self.camera_config.h_to_z(h)
                ax.axhline(z, color="c", linestyle="--")
        return ax

    # -- plot wrappers over the surface getters (reference cross_section.py:1124-1378) --

    @staticmethod
    def _plot_ax(ax, camera: bool):
        import matplotlib.pyplot as plt

        if ax is not None:
            return ax
        if camera:
            _, ax = plt.subplots()
            return ax
        fig = plt.figure()
        return fig.add_subplot(projection="3d")

    @staticmethod
    def _plot_geoms(ax, geoms, camera: bool, **kwargs):
        """Draw polygon(s)/line(s) on a 2-D (camera) or 3-D (world) axes."""
        handles = []
        if geoms is None:
            return handles
        items = list(getattr(geoms, "geoms", [geoms]))
        for g in items:
            coords = np.asarray(
                g.exterior.coords if hasattr(g, "exterior") and g.exterior is not None else g.coords
            )
            if camera:
                handles.append(ax.fill(coords[:, 0], coords[:, 1], **({"alpha": 0.4} | kwargs))[0])
            else:
                from mpl_toolkits.mplot3d.art3d import Poly3DCollection

                poly = Poly3DCollection([coords[:, :3]], **({"alpha": 0.4} | kwargs))
                ax.add_collection3d(poly)
                handles.append(poly)
                ax.auto_scale_xyz(coords[:, 0], coords[:, 1], coords[:, 2])
        return handles

    def plot_cs(self, ax=None, camera: bool = False, swap_y_coords: bool = False, **kwargs):
        """Plot the cross-section line in the world (3d) or camera objective."""
        ax = self._plot_ax(ax, camera)
        if camera:
            pix = self.camera_config.project_points(
                np.column_stack([self.x, self.y, self.z]), within_image=True, swap_y_coords=swap_y_coords
            )
            ax.plot(pix[:, 0], pix[:, 1], **({"color": "#385895"} | kwargs))
        else:
            ax.plot(self.x, self.y, self.z, **({"color": "#385895"} | kwargs))
        return ax

    def plot_planar_surface(
        self, h: float, length: float = 2.0, offset: float = 0.0, camera: bool = False,
        swap_y_coords: bool = False, ax=None, **kwargs,
    ):
        """Plot the planar water surface at level ``h``."""
        ax = self._plot_ax(ax, camera)
        pol = self.get_planar_surface(h, length=length, offset=offset, camera=camera, swap_y_coords=swap_y_coords)
        self._plot_geoms(ax, pol, camera, **({"color": "c"} | kwargs))
        return ax

    def plot_bottom_surface(
        self, length: float = 2.0, offset: float = 0.0, camera: bool = False,
        ax=None, swap_y_coords: bool = False, **kwargs,
    ):
        """Plot the channel bottom surface under the cross-section."""
        ax = self._plot_ax(ax, camera)
        pol = self.get_bottom_surface(length=length, offset=offset, camera=camera, swap_y_coords=swap_y_coords)
        self._plot_geoms(ax, pol, camera, **({"color": "#8B4513"} | kwargs))
        return ax

    def plot_wetted_surface(self, h: float, camera: bool = False, swap_y_coords: bool = False, ax=None, **kwargs):
        """Plot the wetted (submerged) cross-section surface at level ``h``."""
        ax = self._plot_ax(ax, camera)
        pol = self.get_wetted_surface(h, camera=camera, swap_y_coords=swap_y_coords)
        self._plot_geoms(ax, pol, camera, **({"color": "b"} | kwargs))
        return ax

    def plot_bbox_dry_wet(self, h: float, camera: bool = False, ax=None, kwargs_wet=None, kwargs_dry=None):
        """Plot the dry- and wet-bank bounding boxes used for optical water level."""
        ax = self._plot_ax(ax, camera)
        wet = self.get_bbox_dry_wet(h, camera=camera)
        dry = self.get_bbox_dry_wet(h, camera=camera, dry=True)
        self._plot_geoms(ax, wet, camera, **({"color": "b"} | (kwargs_wet or {})))
        self._plot_geoms(ax, dry, camera, **({"color": "y"} | (kwargs_dry or {})))
        return ax

    def plot_water_level(self, h: float, length: float = 2.0, camera: bool = False, ax=None, **kwargs):
        """Plot the hypothesized waterline at level ``h``."""
        ax = self._plot_ax(ax, camera)
        lines = self.get_csl_line(h=h, length=length, camera=camera)
        for line in lines:
            coords = np.asarray(line.coords)
            if camera:
                ax.plot(coords[:, 0], coords[:, 1], **({"color": "c"} | kwargs))
            else:
                ax.plot(coords[:, 0], coords[:, 1], coords[:, 2], **({"color": "c"} | kwargs))
        return ax
