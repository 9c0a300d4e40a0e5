"""2-D affine transforms for (possibly rotated) raster grids.

Replaces the subset of ``rasterio.transform.Affine`` behaviour the reference
relies on, matching the reference's numerics exactly:

- element order as constructed at reference ``pyorc/cv.py:441-473``:
  ``Affine(dx_col, dy_col, x0, dx_row, dy_row, y0)``
- ``pixel_to_map`` (reference ``pyorc/helpers.py:365-389``):
  ``x = x0 + rows*t[1] + cols*t[0]``; corner-based, no half-cell offset.
  (Note: the reference indexes t[1] (dy_col) as x's row coefficient; this is
  numerically correct for equal-resolution rotated grids where dy_col ==
  dx_row, which is the only kind the pipeline produces.)
- ``map_to_pixel`` (reference ``pyorc/helpers.py:392-429``): inverse with
  int64 rounding, returning (rows, cols).
- ``affine_from_grid`` (reference ``pyorc/helpers.py:36-60``): origin at the
  first cell centre.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["Affine", "affine_from_grid", "pixel_to_map", "map_to_pixel", "map_to_pixel_float"]


class Affine:
    """Affine transform stored as (dx_col, dy_col, x0, dx_row, dy_row, y0)."""

    __slots__ = ("elements",)

    def __init__(self, *elements):
        assert len(elements) == 6
        self.elements = tuple(float(e) for e in elements)

    def __getitem__(self, i):
        return self.elements[i]

    def __iter__(self):
        return iter(self.elements)

    def __eq__(self, other):
        return tuple(self) == tuple(other)

    def __repr__(self):
        return f"Affine{self.elements}"

    @property
    def dx_col(self):
        return self.elements[0]

    @property
    def dy_col(self):
        return self.elements[1]

    @property
    def x0(self):
        return self.elements[2]

    @property
    def dx_row(self):
        return self.elements[3]

    @property
    def dy_row(self):
        return self.elements[4]

    @property
    def y0(self):
        return self.elements[5]


def affine_from_grid(xi: np.ndarray, yi: np.ndarray) -> Affine:
    """Affine of a (possibly rotated) grid from 2-D coordinate rasters (cell centres)."""
    xul, yul = xi[0, 0], yi[0, 0]
    dx_col = xi[0, 1] - xul
    dy_col = yi[0, 1] - yul
    dx_row = xi[1, 0] - xul
    dy_row = yi[1, 0] - yul
    return Affine(dx_col, dy_col, xul, dx_row, dy_row, yul)


def pixel_to_map(cols, rows, transform) -> Tuple[np.ndarray, np.ndarray]:
    """(col, row) -> (x, y), matching reference helpers.pixel_to_map exactly."""
    cols = np.asarray(cols, dtype=np.float64)
    rows = np.asarray(rows, dtype=np.float64)
    t = tuple(transform)
    x_map = t[2] + rows * t[1] + cols * t[0]
    y_map = t[5] + rows * t[4] + cols * t[3]
    return x_map, y_map


def _inverse_2x2(t):
    det = t[1] * t[3] - t[0] * t[4]
    inv_det = 1.0 / det
    return [t[3] * inv_det, -t[0] * inv_det, -t[4] * inv_det, t[1] * inv_det]


def map_to_pixel(xs, ys, transform) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) -> integer (rows, cols), matching reference helpers.map_to_pixel exactly."""
    t = tuple(transform)
    inv = _inverse_2x2(t)
    dx = np.asarray(xs, dtype=np.float64) - t[2]
    dy = np.asarray(ys, dtype=np.float64) - t[5]
    row = np.int64(np.round(inv[0] * dx + inv[1] * dy))
    col = np.int64(np.round(inv[2] * dx + inv[3] * dy))
    return row, col


def map_to_pixel_float(xs, ys, transform) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) -> fractional (rows, cols); the op=float variant used for bbox coords."""
    t = tuple(transform)
    inv = _inverse_2x2(t)
    dx = np.asarray(xs, dtype=np.float64) - t[2]
    dy = np.asarray(ys, dtype=np.float64) - t[5]
    row = inv[0] * dx + inv[1] * dy
    col = inv[2] * dx + inv[3] * dy
    return row, col
