"""Geometry core: camera model, pose solvers, CRS, affine, planar shapes.

Host-side float64 numpy — these are tiny problems solved once per video; the
device kernels consume the sampling grids this module produces.
"""

from . import affine, aoi, camera, crs, shapes

__all__ = ["camera", "crs", "affine", "shapes", "aoi"]
