"""Minimal planar geometry: Point / LineString / Polygon (+ WKT, affinity).

Stand-in for the subset of shapely the reference uses (Polygon bboxes with
exterior/centroid/area/contains, LineString length/interpolate/project/
intersection, affinity rotate/translate/scale, WKT round-trip — reference
call sites: ``pyorc/api/cameraconfig.py:174,513,991-1052``,
``pyorc/api/cross_section.py`` throughout). Pure numpy; geometries may carry
z values which ride along unchanged through 2-D operations.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "Point",
    "LineString",
    "Polygon",
    "MultiPolygon",
    "MultiLineString",
    "loads",
    "dumps",
    "rotate",
    "translate",
    "scale",
    "box",
    "force_3d",
    "force_2d",
]


class _Geom:
    _coords: np.ndarray  # (N, 2) or (N, 3)

    @property
    def coords(self) -> List[Tuple[float, ...]]:
        return [tuple(c) for c in self._coords]

    @property
    def has_z(self) -> bool:
        return self._coords.shape[1] == 3

    @property
    def xy(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._coords[:, 0].copy(), self._coords[:, 1].copy()

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        xs, ys = self._coords[:, 0], self._coords[:, 1]
        return float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())

    @property
    def is_empty(self) -> bool:
        return len(self._coords) == 0


def _as_coords(coords) -> np.ndarray:
    if isinstance(coords, _Geom):
        return coords._coords.copy()
    arr = np.asarray([list(c.coords[0]) if isinstance(c, Point) else list(c) for c in coords], dtype=np.float64)
    return arr


class Point(_Geom):
    def __init__(self, *args):
        if len(args) == 1:
            args = tuple(np.asarray(args[0], dtype=np.float64).ravel())
        self._coords = np.asarray([args], dtype=np.float64)

    @property
    def x(self) -> float:
        return float(self._coords[0, 0])

    @property
    def y(self) -> float:
        return float(self._coords[0, 1])

    @property
    def z(self) -> float:
        return float(self._coords[0, 2])

    def distance(self, other: "Point") -> float:
        return float(np.linalg.norm(self._coords[0, :2] - other._coords[0, :2]))

    def buffer(self, dist: float, resolution: int = 16) -> "Polygon":
        ang = np.linspace(0, 2 * np.pi, 4 * resolution, endpoint=False)
        pts = np.stack([self.x + dist * np.cos(ang), self.y + dist * np.sin(ang)], axis=-1)
        return Polygon(pts)

    def __repr__(self):
        return f"POINT ({' '.join(f'{v:g}' for v in self._coords[0])})"


class LineString(_Geom):
    def __init__(self, coords):
        self._coords = _as_coords(coords)

    @property
    def length(self) -> float:
        d = np.diff(self._coords[:, :2], axis=0)
        return float(np.sum(np.hypot(d[:, 0], d[:, 1])))

    @property
    def centroid(self) -> Point:
        # length-weighted centroid of segments
        p = self._coords[:, :2]
        mid = (p[:-1] + p[1:]) / 2
        w = np.hypot(*(p[1:] - p[:-1]).T)
        if w.sum() == 0:
            return Point(*p[0])
        return Point(*(mid * w[:, None]).sum(axis=0) / w.sum())

    def _cum(self) -> np.ndarray:
        d = np.diff(self._coords[:, :2], axis=0)
        return np.concatenate([[0.0], np.cumsum(np.hypot(d[:, 0], d[:, 1]))])

    def interpolate(self, distance: float, normalized: bool = False) -> Point:
        s = self._cum()
        dist = distance * s[-1] if normalized else distance
        dist = np.clip(dist, 0, s[-1])
        i = int(np.clip(np.searchsorted(s, dist) - 1, 0, len(s) - 2))
        seg = s[i + 1] - s[i]
        t = 0.0 if seg == 0 else (dist - s[i]) / seg
        pt = self._coords[i] + t * (self._coords[i + 1] - self._coords[i])
        return Point(*pt)

    def project(self, point: Point, normalized: bool = False) -> float:
        """Distance along the line of the closest point to `point`."""
        p = np.array([point.x, point.y])
        best_d, best_s = np.inf, 0.0
        s = self._cum()
        for i in range(len(self._coords) - 1):
            a = self._coords[i, :2]
            b = self._coords[i + 1, :2]
            ab = b - a
            denom = ab @ ab
            t = 0.0 if denom == 0 else float(np.clip((p - a) @ ab / denom, 0, 1))
            proj = a + t * ab
            d = np.hypot(*(p - proj))
            if d < best_d:
                best_d = d
                best_s = s[i] + t * np.hypot(*ab)
        return best_s / s[-1] if normalized else float(best_s)

    def distance(self, point: Point) -> float:
        p = np.array([point.x, point.y])
        best = np.inf
        for i in range(len(self._coords) - 1):
            a, b = self._coords[i, :2], self._coords[i + 1, :2]
            ab = b - a
            denom = ab @ ab
            t = 0.0 if denom == 0 else float(np.clip((p - a) @ ab / denom, 0, 1))
            best = min(best, float(np.hypot(*(p - (a + t * ab)))))
        return best

    def intersection(self, other: Union["LineString", "Polygon"]):
        if isinstance(other, Polygon):
            return other.intersection(self)
        pts = []
        for i in range(len(self._coords) - 1):
            for j in range(len(other._coords) - 1):
                pt = _seg_intersect(
                    self._coords[i, :2], self._coords[i + 1, :2], other._coords[j, :2], other._coords[j + 1, :2]
                )
                if pt is not None:
                    pts.append(pt)
        if not pts:
            return MultiPoint([])
        if len(pts) == 1:
            return Point(*pts[0])
        return MultiPoint([Point(*p) for p in pts])

    def intersects(self, other) -> bool:
        out = self.intersection(other)
        return not out.is_empty

    def __repr__(self):
        pts = ", ".join(" ".join(f"{v:g}" for v in c) for c in self._coords)
        return f"LINESTRING ({pts})"


class MultiPoint(_Geom):
    def __init__(self, points: Sequence[Point]):
        self.geoms = list(points)
        self._coords = (
            np.concatenate([p._coords for p in self.geoms], axis=0) if self.geoms else np.zeros((0, 2))
        )

    def __iter__(self):
        return iter(self.geoms)

    def __len__(self):
        return len(self.geoms)


class Polygon(_Geom):
    def __init__(self, shell):
        arr = _as_coords(shell)
        # drop an explicit closing point; we treat the ring as implicitly closed.
        # NB: absolute tolerance only — relative tolerance would collapse distinct
        # corners at large (UTM) coordinate magnitudes.
        if len(arr) > 1 and np.max(np.abs(arr[0] - arr[-1])) < 1e-9:
            arr = arr[:-1]
        self._ring = arr

    @property
    def exterior(self) -> LineString:
        return LineString(np.concatenate([self._ring, self._ring[:1]], axis=0))

    @property
    def _coords(self) -> np.ndarray:  # type: ignore[override]
        return self._ring

    @property
    def area(self) -> float:
        x, y = self._ring[:, 0], self._ring[:, 1]
        return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2)

    @property
    def centroid(self) -> Point:
        x, y = self._ring[:, 0], self._ring[:, 1]
        xn, yn = np.roll(x, -1), np.roll(y, -1)
        cross = x * yn - xn * y
        a = cross.sum() / 2
        if abs(a) < 1e-15:
            return Point(x.mean(), y.mean())
        cx = ((x + xn) * cross).sum() / (6 * a)
        cy = ((y + yn) * cross).sum() / (6 * a)
        return Point(cx, cy)

    def contains(self, other: Union[Point, "Polygon", LineString]) -> bool:
        if isinstance(other, Point):
            return bool(points_in_polygon(other._coords[:, :2], self._ring[:, :2])[0])
        return bool(points_in_polygon(other._coords[:, :2], self._ring[:, :2]).all())

    def contains_points(self, pts: np.ndarray) -> np.ndarray:
        return points_in_polygon(np.asarray(pts, dtype=np.float64), self._ring[:, :2])

    @property
    def is_empty(self) -> bool:
        return len(self._ring) < 3

    @property
    def is_valid(self) -> bool:
        return len(self._ring) >= 3 and self.area > 0

    def intersection(self, other):
        if isinstance(other, LineString):
            return _clip_line_to_polygon(other, self)
        if isinstance(other, MultiPolygon):
            return MultiPolygon([self.intersection(g) for g in other.geoms if not self.intersection(g).is_empty])
        ring = _sutherland_hodgman(other._ring[:, :2], self._ring[:, :2])
        return Polygon(ring) if len(ring) >= 3 else Polygon(np.zeros((0, 2)))

    def difference(self, other, resolution: float = 0.01):
        return polygon_difference(self, other, resolution=resolution)

    def intersects(self, other) -> bool:
        if isinstance(other, Point):
            return self.contains(other)
        out = self.intersection(other)
        if isinstance(out, Polygon):
            return len(out._ring) >= 3 and out.area > 0
        return not out.is_empty

    def buffer(self, dist: float, **kw) -> "Polygon":
        if dist == 0:
            return Polygon(self._ring.copy())
        # simple vertex-offset buffer along angle bisectors (adequate for convex AOIs)
        ring = self._ring[:, :2]
        n = len(ring)
        # ensure CCW
        if _signed_area(ring) < 0:
            ring = ring[::-1]
        out = []
        for i in range(n):
            p_prev, p, p_next = ring[i - 1], ring[i], ring[(i + 1) % n]
            d1 = p - p_prev
            d2 = p_next - p
            n1 = np.array([d1[1], -d1[0]])
            n2 = np.array([d2[1], -d2[0]])
            n1 /= max(np.linalg.norm(n1), 1e-12)
            n2 /= max(np.linalg.norm(n2), 1e-12)
            bis = n1 + n2
            norm = np.linalg.norm(bis)
            if norm < 1e-12:
                bis = n1
                norm = 1.0
            bis /= norm
            denom = max(1 + n1 @ n2, 1e-6)
            out.append(p + bis * dist * np.sqrt(2 / denom))
        return Polygon(np.asarray(out))

    def __repr__(self):
        ring = np.concatenate([self._ring, self._ring[:1]], axis=0)
        pts = ", ".join(" ".join(f"{v}" for v in c) for c in ring)
        return f"POLYGON (({pts}))"


class MultiPolygon(_Geom):
    def __init__(self, polygons):
        self.geoms = [p for p in polygons if isinstance(p, Polygon)]
        self._coords = (
            np.concatenate([p._ring for p in self.geoms], axis=0) if self.geoms else np.zeros((0, 2))
        )

    @property
    def area(self) -> float:
        return float(sum(p.area for p in self.geoms))

    @property
    def centroid(self) -> Point:
        if not self.geoms:
            return Point(np.nan, np.nan)
        areas = np.array([max(p.area, 1e-12) for p in self.geoms])
        cents = np.array([[p.centroid.x, p.centroid.y] for p in self.geoms])
        c = (cents * areas[:, None]).sum(axis=0) / areas.sum()
        return Point(*c)

    def __iter__(self):
        return iter(self.geoms)

    def __len__(self):
        return len(self.geoms)

    def __repr__(self):
        return f"MULTIPOLYGON ({len(self.geoms)} parts)"


class MultiLineString(_Geom):
    def __init__(self, lines):
        self.geoms = [l for l in lines if isinstance(l, LineString) and not l.is_empty]
        self._coords = (
            np.concatenate([l._coords for l in self.geoms], axis=0) if self.geoms else np.zeros((0, 2))
        )

    @property
    def length(self) -> float:
        return float(sum(l.length for l in self.geoms))

    def __iter__(self):
        return iter(self.geoms)

    def __len__(self):
        return len(self.geoms)

    def __repr__(self):
        return f"MULTILINESTRING ({len(self.geoms)} parts)"


def box(minx, miny, maxx, maxy) -> Polygon:
    return Polygon([(minx, miny), (maxx, miny), (maxx, maxy), (minx, maxy)])


def polygon_difference(a: Polygon, b, resolution: float = 0.01):
    """a minus b via rasterization + contour extraction (host OpenCV).

    General polygon boolean difference is only needed for region
    visualisation (dry/wet bbox split); a raster-backed implementation at the
    working resolution is accurate to ~1 cell and robust for any shapes.
    Returns a MultiPolygon.
    """
    import cv2

    minx, miny, maxx, maxy = a.bounds
    pad = 2 * resolution
    minx -= pad
    miny -= pad
    maxx += pad
    maxy += pad
    w = max(int(np.ceil((maxx - minx) / resolution)), 2)
    h = max(int(np.ceil((maxy - miny) / resolution)), 2)
    # cap raster size for safety
    scale_f = max(w, h) / 4000
    if scale_f > 1:
        resolution *= scale_f
        w = int(np.ceil((maxx - minx) / resolution))
        h = int(np.ceil((maxy - miny) / resolution))

    def to_px(ring):
        pts = (ring[:, :2] - [minx, miny]) / resolution
        return np.round(pts).astype(np.int32)

    mask = np.zeros((h, w), np.uint8)
    cv2.fillPoly(mask, [to_px(a._ring)], 1)
    b_geoms = b.geoms if isinstance(b, MultiPolygon) else [b]
    for g in b_geoms:
        cv2.fillPoly(mask, [to_px(g._ring)], 0)
    contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    polys = []
    for c in contours:
        if len(c) >= 3:
            ring = c[:, 0, :].astype(np.float64) * resolution + [minx, miny]
            polys.append(Polygon(ring))
    return MultiPolygon(polys)


def force_2d(geom):
    if isinstance(geom, MultiPolygon):
        return MultiPolygon([force_2d(g) for g in geom.geoms])
    arr = geom._ring if isinstance(geom, Polygon) else geom._coords
    arr2 = arr[:, :2]
    if isinstance(geom, Polygon):
        return Polygon(arr2)
    if isinstance(geom, LineString):
        return LineString(arr2)
    return Point(*arr2[0])


def force_3d(geom, z: float = 0.0):
    if isinstance(geom, MultiPolygon):
        return MultiPolygon([force_3d(g, z) for g in geom.geoms])
    arr = geom._coords if not isinstance(geom, Polygon) else geom._ring
    if arr.shape[1] == 3:
        return geom
    arr3 = np.column_stack([arr, np.full(len(arr), z)])
    if isinstance(geom, Polygon):
        return Polygon(arr3)
    if isinstance(geom, LineString):
        return LineString(arr3)
    return Point(*arr3[0])


def _signed_area(ring: np.ndarray) -> float:
    x, y = ring[:, 0], ring[:, 1]
    return float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2


def points_in_polygon(pts: np.ndarray, ring: np.ndarray) -> np.ndarray:
    """Vectorized even-odd point-in-polygon test (boundary counts as inside)."""
    x, y = pts[:, 0], pts[:, 1]
    n = len(ring)
    inside = np.zeros(len(pts), dtype=bool)
    for i in range(n):
        x1, y1 = ring[i]
        x2, y2 = ring[(i + 1) % n]
        cond = (y1 > y) != (y2 > y)
        denom = y2 - y1
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = x1 + (y - y1) * (x2 - x1) / np.where(denom == 0, np.inf, denom)
        inside ^= cond & (x < xint)
    # boundary tolerance
    for i in range(n):
        a, b = ring[i], ring[(i + 1) % n]
        ab = b - a
        denom = ab @ ab
        if denom == 0:
            continue
        t = np.clip(((pts - a) @ ab) / denom, 0, 1)
        d = np.hypot(*(pts - (a + t[:, None] * ab)).T)
        inside |= d < 1e-9
    return inside


def _seg_intersect(p1, p2, p3, p4) -> Optional[np.ndarray]:
    d1 = p2 - p1
    d2 = p4 - p3
    denom = d1[0] * d2[1] - d1[1] * d2[0]
    if abs(denom) < 1e-15:
        return None
    diff = p3 - p1
    t = (diff[0] * d2[1] - diff[1] * d2[0]) / denom
    u = (diff[0] * d1[1] - diff[1] * d1[0]) / denom
    if -1e-12 <= t <= 1 + 1e-12 and -1e-12 <= u <= 1 + 1e-12:
        return p1 + t * d1
    return None


def _sutherland_hodgman(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Clip subject polygon by convex clip polygon."""
    if _signed_area(clip) < 0:
        clip = clip[::-1]
    output = list(subject)
    n = len(clip)
    for i in range(n):
        a, b = clip[i], clip[(i + 1) % n]
        edge = b - a
        input_ring = output
        output = []
        if not input_ring:
            break
        for j in range(len(input_ring)):
            p = input_ring[j]
            q = input_ring[(j + 1) % len(input_ring)]
            p_in = edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= -1e-12
            q_in = edge[0] * (q[1] - a[1]) - edge[1] * (q[0] - a[0]) >= -1e-12
            if p_in:
                output.append(p)
                if not q_in:
                    ipt = _line_intersect_inf(p, q, a, b)
                    if ipt is not None:
                        output.append(ipt)
            elif q_in:
                ipt = _line_intersect_inf(p, q, a, b)
                if ipt is not None:
                    output.append(ipt)
    return np.asarray(output) if output else np.zeros((0, 2))


def _line_intersect_inf(p, q, a, b) -> Optional[np.ndarray]:
    d1 = q - p
    d2 = b - a
    denom = d1[0] * d2[1] - d1[1] * d2[0]
    if abs(denom) < 1e-15:
        return None
    t = ((a - p)[0] * d2[1] - (a - p)[1] * d2[0]) / denom
    return p + t * d1


def _clip_line_to_polygon(line: LineString, poly: Polygon) -> LineString:
    """Clip a linestring to a convex polygon (keeps interior pieces)."""
    pts = []
    inside = poly.contains_points(line._coords[:, :2])
    for i in range(len(line._coords) - 1):
        p, q = line._coords[i], line._coords[i + 1]
        if inside[i]:
            pts.append(p)
        crossing = []
        for j in range(len(poly._ring)):
            a = poly._ring[j, :2]
            b = poly._ring[(j + 1) % len(poly._ring), :2]
            ipt = _seg_intersect(p[:2], q[:2], a, b)
            if ipt is not None:
                # carry z by linear interpolation if present
                if line.has_z:
                    t = np.hypot(*(ipt - p[:2])) / max(np.hypot(*(q[:2] - p[:2])), 1e-12)
                    ipt = np.array([ipt[0], ipt[1], p[2] + t * (q[2] - p[2])])
                crossing.append(ipt)
        crossing.sort(key=lambda c: np.hypot(*(np.asarray(c[:2]) - p[:2])))
        pts.extend(crossing)
    if inside[-1]:
        pts.append(line._coords[-1])
    if len(pts) < 2:
        return LineString(np.zeros((0, line._coords.shape[1])))
    return LineString(np.asarray(pts))


# -- affinity ------------------------------------------------------------------


def _transform_geom(geom, fn):
    arr = geom._ring if isinstance(geom, Polygon) else geom._coords
    xy = fn(arr[:, :2])
    out = np.column_stack([xy, arr[:, 2]]) if arr.shape[1] == 3 else xy
    if isinstance(geom, Polygon):
        return Polygon(out)
    if isinstance(geom, LineString):
        return LineString(out)
    return Point(*out[0])


def _origin_point(geom, origin):
    if origin == "center":  # bounding-box centre (shapely semantics)
        minx, miny, maxx, maxy = geom.bounds
        return np.array([(minx + maxx) / 2, (miny + maxy) / 2])
    if origin == "centroid":
        c = geom.centroid
        return np.array([c.x, c.y])
    if isinstance(origin, Point):
        return np.array([origin.x, origin.y])
    return np.asarray(origin, dtype=np.float64)[:2]


def rotate(geom, angle: float, origin="center", use_radians: bool = False):
    theta = angle if use_radians else np.radians(angle)
    o = _origin_point(geom, origin)
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]])
    return _transform_geom(geom, lambda xy: (xy - o) @ R.T + o)


def translate(geom, xoff: float = 0.0, yoff: float = 0.0):
    return _transform_geom(geom, lambda xy: xy + np.array([xoff, yoff]))


def scale(geom, xfact: float = 1.0, yfact: float = 1.0, origin="center"):
    o = _origin_point(geom, origin)
    return _transform_geom(geom, lambda xy: (xy - o) * np.array([xfact, yfact]) + o)


# -- WKT ------------------------------------------------------------------


def dumps(geom) -> str:
    return repr(geom)


def loads(s: str):
    s = s.strip()
    m = re.match(r"^(\w+)\s*(.*)$", s, re.S)
    kind = m.group(1).upper()
    body = m.group(2)
    nums = lambda txt: [
        tuple(float(v) for v in pt.strip().split()) for pt in txt.split(",") if pt.strip()
    ]
    if kind == "POINT":
        inner = re.search(r"\(([^()]*)\)", body).group(1)
        return Point(*[float(v) for v in inner.split()])
    if kind == "LINESTRING":
        inner = re.search(r"\(([^()]*)\)", body).group(1)
        return LineString(nums(inner))
    if kind == "POLYGON":
        inner = re.search(r"\(\s*\(([^()]*)\)", body).group(1)
        return Polygon(nums(inner))
    raise ValueError(f"unsupported WKT: {s[:40]}")


# -- polygon rasterization ---------------------------------------------------------

_XY_SHIFT = 16  # fixed-point fraction bits of the scan-line edge walker


def _clip_segment(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """Cohen-Sutherland clip of an integer segment to the ``w x h`` image.

    Returns ``(inside, x1, y1, x2, y2)``. The end points move even when the
    segment turns out to miss the image: the polygon fill below reads them.
    """
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _inside(w: int, h: int, x1: int, y1: int, x2: int, y2: int) -> bool:
    return 0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h


def _draw_segment(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """8-connected Bresenham segment, walked left to right, clipped to the mask."""
    h, w = mask.shape
    if not _inside(w, h, x1, y1, x2, y2):
        ok, x1, y1, x2, y2 = _clip_segment(w, h, x1, y1, x2, y2)
        if not ok:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        mask[y, x] = True
        minor = err < 0
        err += 2 * dx - 2 * dy if minor else -2 * dy
        if steep:
            y += sy
            x += minor
        else:
            x += 1
            y += sy if minor else 0


def _cdiv(a: int, b: int) -> int:
    """Integer division truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def fill_polygon(shape: Tuple[int, int], ring) -> np.ndarray:
    """Boolean ``(h, w)`` raster of a polygon with integer vertices.

    Gives the same pixels as ``cv2.fillPoly(mask, [ring], 1)`` (8-connected
    outline, scan-line interior with 16-bit fixed-point edge walking; pixel
    spans run from the ceiling of the left edge to the floor of the right
    one), so camera-frame AOI masks need no OpenCV. ``ring`` is ``[n, 2]``
    ``(x, y)``; the ring closes itself.
    """
    h, w = int(shape[0]), int(shape[1])
    mask = np.zeros((h, w), dtype=bool)
    pts = [(int(p[0]), int(p[1])) for p in np.asarray(ring)]
    edges = []  # [y_top, x_fixed at y_top, dx_fixed per row, y_bottom]
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        _draw_segment(mask, x0, y0, x1, y1)
        p0x, p0y, p1x, p1y = x0 << _XY_SHIFT, y0, x1 << _XY_SHIFT, y1
        if not _inside(w, h, x0, y0, x1, y1):
            _, tx0, ty0, tx1, ty1 = _clip_segment(w, h, x0, y0, x1, y1)
            p0x, p1x = tx0 << _XY_SHIFT, tx1 << _XY_SHIFT
            if ty0 != ty1:
                p0y, p1y = ty0, ty1
        if y0 != y1:
            dxe = _cdiv(p1x - p0x, p1y - p0y)
            if y0 < y1:
                edges.append([y0, p0x + (y0 - p0y) * dxe, dxe, y1])
            else:
                edges.append([y1, p1x + (y1 - p1y) * dxe, dxe, y0])
        x0, y0 = x1, y1
    if len(edges) < 2:
        return mask
    y_max = max(e[3] for e in edges)
    xs = [e[1] for e in edges] + [e[1] + (e[3] - e[0]) * e[2] for e in edges]
    if y_max < 0 or min(e[0] for e in edges) >= h or max(xs) < 0 or min(xs) >= (w << _XY_SHIFT):
        return mask
    edges.sort(key=lambda e: (e[0], e[1], e[2]))
    one_minus = (1 << _XY_SHIFT) - 1
    nxt = 0
    active = []
    for y in range(edges[0][0], min(y_max, h)):
        active = [e for e in active if e[3] != y]
        # merge the edges that start on this row into the x-sorted active list
        merged, j = [], 0
        while nxt < len(edges) and edges[nxt][0] == y:
            e = edges[nxt]
            while j < len(active) and active[j][1] < e[1]:
                merged.append(active[j])
                j += 1
            merged.append(e)
            nxt += 1
        active = merged + active[j:]
        for a, b in zip(active[0::2], active[1::2]):
            if y >= 0:
                xl, xr = min(a[1], b[1]), max(a[1], b[1])
                c0, c1 = (xl + one_minus) >> _XY_SHIFT, xr >> _XY_SHIFT
                if c0 < w and c1 >= 0:
                    mask[y, max(c0, 0) : min(c1, w - 1) + 1] = True
            a[1] += a[2]
            b[1] += b[2]
        active.sort(key=lambda e: e[1])
    return mask
