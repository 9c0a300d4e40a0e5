"""Area-of-interest bounding-box construction on the water plane.

Mirrors reference ``pyorc/cv.py:92-139`` (_get_aoi_corners /
_get_aoi_width_length) and ``cv.py:411-473`` (_get_shape / _get_transform),
built on our shapes/affine modules.
"""

from __future__ import annotations

import numpy as np

from . import shapes
from .affine import Affine, map_to_pixel_float

__all__ = ["get_aoi", "get_shape", "get_transform", "round_to_multiple", "transform_to_bbox"]


def round_to_multiple(number: float, multiple: float) -> float:
    """Round number to a multiple of a certain number. Reference pyorc/helpers.py:633."""
    return multiple * round(number / multiple)


def get_aoi(dst_corners, resolution=None, method: str = "corners") -> shapes.Polygon:
    """Bounding-box polygon from 4 corner points or 3 width/length points.

    Coordinate order of the result: upstream-left, downstream-left,
    downstream-right, upstream-right (reference pyorc/cv.py:92-139).
    """
    if method == "corners":
        return _get_aoi_corners(dst_corners, resolution)
    return _get_aoi_width_length(dst_corners)


def _get_aoi_corners(dst_corners, resolution=None) -> shapes.Polygon:
    polygon = shapes.Polygon(np.asarray(dst_corners, dtype=np.float64)[:, :2])
    coords = np.asarray(polygon.exterior.coords)
    point1 = (coords[0] + coords[3]) / 2
    point2 = (coords[1] + coords[2]) / 2
    diff = point2 - point1
    angle = np.arctan2(diff[1], diff[0])
    origin = tuple(np.asarray(dst_corners[0], dtype=np.float64)[:2])
    polygon_rotate = shapes.rotate(polygon, -angle, origin=origin, use_radians=True)
    xmin, ymin, xmax, ymax = polygon_rotate.bounds
    if resolution is not None:
        xmin = round_to_multiple(xmin, resolution)
        xmax = round_to_multiple(xmax, resolution)
        ymin = round_to_multiple(ymin, resolution)
        ymax = round_to_multiple(ymax, resolution)
    bbox_coords = [(xmin, ymax), (xmax, ymax), (xmax, ymin), (xmin, ymin), (xmin, ymax)]
    bbox = shapes.Polygon(bbox_coords)
    return shapes.rotate(bbox, angle, origin=origin, use_radians=True)


def _get_aoi_width_length(dst_corners) -> shapes.Polygon:
    pts = np.asarray(dst_corners, dtype=np.float64)[:, :2]
    line = shapes.LineString([pts[0], pts[1]])
    length = abs(_perpendicular_distance(pts[-1], pts[0], pts[1]))
    point1, point2 = pts[0], pts[1]
    diff = point2 - point1
    angle = np.arctan2(diff[1], diff[0])
    xy_diff = np.array([np.sin(-angle) * length, np.cos(angle) * length])
    points_pol = np.array([point1 - xy_diff, point1 + xy_diff, point2 + xy_diff, point2 - xy_diff])
    del line
    return shapes.Polygon(points_pol)


def _perpendicular_distance(p3, p1, p2) -> float:
    """Signed perpendicular distance from p3 to the (extended) line p1-p2.

    Sign convention per reference pyorc/cv.py:206-250.
    """
    line_vector = p2 - p1
    point_vector = p3 - p1
    unit_line = line_vector / np.linalg.norm(line_vector)
    projection_length = point_vector @ unit_line
    perpendicular_vector = point_vector - projection_length * unit_line
    d = np.linalg.norm(perpendicular_vector)
    cross = line_vector[0] * point_vector[1] - line_vector[1] * point_vector[0]
    return d if cross > 0 else -d


def get_shape(bbox: shapes.Polygon, resolution: float = 0.01, round: int = 1):
    """(cols, rows) of the projected grid for a bbox. Reference pyorc/cv.py:411-438."""
    coords = bbox.exterior.coords
    box_length = shapes.LineString(coords[0:2]).length
    box_width = shapes.LineString(coords[1:3]).length
    cols = int(np.round((box_length / resolution) / round)) * round
    rows = int(np.round((box_width / resolution) / round)) * round
    return cols, rows


def get_transform(bbox: shapes.Polygon, resolution: float = 0.01) -> Affine:
    """Rotated affine for the bbox grid. Reference pyorc/cv.py:441-473.

    Column axis runs along the first bbox edge (upstream-left ->
    downstream-left); row axis at -90 degrees from it.
    """
    corners = np.asarray(bbox.exterior.coords)
    p1, p2 = corners[0], corners[1]
    diff = p2 - p1
    angle = np.arctan2(diff[1], diff[0])
    dx_col, dy_col = np.cos(angle) * resolution, np.sin(angle) * resolution
    dx_row = np.cos(angle + 1.5 * np.pi) * resolution
    dy_row = np.sin(angle + 1.5 * np.pi) * resolution
    return Affine(dx_col, dy_col, p1[0], dx_row, dy_row, p1[1])


def transform_to_bbox(coords, bbox: shapes.Polygon, resolution: float):
    """World coordinates -> fractional (col, row) in the bbox grid. Reference pyorc/cv.py:1363-1389."""
    transform = get_transform(bbox, resolution)
    coords = np.asarray(coords, dtype=np.float64)
    rows, cols = map_to_pixel_float(coords[:, 0], coords[:, 1], transform)
    if coords.shape[1] == 3:
        return list(zip(cols, rows, coords[:, 2]))
    return list(zip(cols, rows))
