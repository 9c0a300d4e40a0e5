"""Top-level projection functions, API-compatible with the reference.

The port of :mod:`pyorc_tpu.project`. The reference exports ``project_numpy``
/ ``project_cv`` at package level (reference ``pyorc/project.py:16``); both
map FOV pixels onto the target ortho grid. Here both run the port's index-map
projection (:mod:`pyorc_tpu_torch.ops.ortho`): the maps are built on the host
and the gather runs on :func:`pyorc_tpu_torch.get_device`, as in
``Frames.project``. The reference's cv2 undistort + warpPerspective variant
(``project_cv``, reference project.py:56-120) is an alias: the homography and
the lens model are baked into the same maps. Prefer the ``frames.project()``
accessor, which also attaches coordinates.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from . import ndx
from ._device import get_device, to_device, to_host
from .ops import ortho as ortho_ops

__all__ = ["project_numpy", "project_cv"]


def project_numpy(
    da: "ndx.DataArray",
    cc: Any,
    x: np.ndarray,
    y: np.ndarray,
    z: float,
    reducer: Optional[str] = "mean",
) -> "ndx.DataArray":
    """Project frames onto the (x, y) target grid at plane level ``z``.

    Matches the reference contract (reference ``pyorc/project.py:164-230``):
    nearest-neighbour index mapping with optional group-``reducer`` for
    oversampled target pixels. The per-frame work is a gather and a segment
    mean on the device (:func:`pyorc_tpu_torch.ops.ortho.project_batch`).
    """
    maps = ortho_ops.build_ortho_maps(cc, np.asarray(x), np.asarray(y), z, reducer=reducer or "nearest")
    data = np.asarray(da.values if hasattr(da, "values") else da)
    squeeze = data.ndim == 2
    if squeeze:
        data = data[None]
    dmaps = ortho_ops.device_maps(maps, get_device())
    out = to_host(ortho_ops.project_batch(to_device(data), maps, dmaps)).astype(data.dtype, copy=False)
    if squeeze:
        out = out[0]
    if not hasattr(da, "dims"):
        return out
    coords = {k: v for k, v in da.coords.items() if "y" not in getattr(v, "dims", ("y",)) and "x" not in getattr(v, "dims", ("x",))}
    coords["y"] = np.asarray(y)
    coords["x"] = np.asarray(x)
    dims = tuple(da.dims)
    return ndx.DataArray(out, dims=dims, coords=coords, attrs=dict(da.attrs), name=da.name)


def project_cv(
    da: "ndx.DataArray",
    cc: Any,
    x: np.ndarray,
    y: np.ndarray,
    z: float,
    reducer: Optional[str] = None,
) -> "ndx.DataArray":
    """cv2-style projection entry point (undistort + perspective warp in the
    reference); here an alias of :func:`project_numpy` with nearest-neighbour
    sampling — the same undistortion + homography are baked into the
    precomputed index maps."""
    return project_numpy(da, cc, x, y, z, reducer=reducer)
