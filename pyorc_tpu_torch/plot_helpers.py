"""Shapely-geometry plotting helpers (reference ``pyorc/plot_helpers.py:8-62``).

A copy of :mod:`pyorc_tpu.plot_helpers`. Draw in-tree :mod:`pyorc_tpu_torch.geom.shapes` geometries (or anything exposing
the same ``coords`` / ``exterior`` / ``geoms`` protocol, including shapely
objects) onto matplotlib 2-D or 3-D axes.
"""

from __future__ import annotations

__all__ = ["plot_polygon", "plot_3d_polygon", "plot_line", "plot_3d_line"]


def _polys(polygon):
    return polygon.geoms if hasattr(polygon, "geoms") else [polygon]


def plot_polygon(polygon, ax=None, **kwargs):
    """Draw a (Multi)Polygon as filled patches on a 2-D axes."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.axes()
    p = None
    for pol in _polys(polygon):
        patch = plt.Polygon([c[:2] for c in pol.exterior.coords], **kwargs)
        p = ax.add_patch(patch)
        kwargs.pop("label", None)  # label only the first patch
    return p


def plot_3d_polygon(polygon, ax=None, **kwargs):
    """Draw a (Multi)Polygon with z-coordinates on a 3-D axes."""
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    if ax is None:
        ax = plt.axes(projection="3d")
    p = None
    for pol in _polys(polygon):
        verts = [[tuple(c[:3]) for c in pol.exterior.coords]]
        p = ax.add_collection3d(Poly3DCollection(verts, **kwargs))
        # add_collection3d does not grow the data limits; without this a
        # world-coordinate polygon lands outside the default [0, 1] view
        xyz = list(zip(*verts[0]))
        ax.auto_scale_xyz(xyz[0], xyz[1], xyz[2])
        kwargs.pop("label", None)
    return p


def plot_line(line, ax=None, **kwargs):
    """Draw a LineString on a 2-D axes."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.axes()
    x, y = zip(*[c[:2] for c in line.coords])
    return ax.plot(x, y, **kwargs)


def plot_3d_line(line, ax=None, **kwargs):
    """Draw a LineString with z-coordinates on a 3-D axes."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.axes(projection="3d")
    x, y, z = zip(*[tuple(c[:3]) for c in line.coords])
    return ax.plot(x, y, z, **kwargs)
