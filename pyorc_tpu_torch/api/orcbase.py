"""Shared accessor base: deserializes camera_config from attrs, exposes h_a.

Mirrors reference ``pyorc/api/orcbase.py:16-119``.
"""

from __future__ import annotations

import json

import numpy as np

from .. import ndx
from .cameraconfig import get_camera_config


class ORCBase:
    def __init__(self, obj):
        self._obj = obj

    @property
    def camera_config(self):
        if not hasattr(self, "_camera_config"):
            self._set_camera_config()
        return self._camera_config

    @camera_config.setter
    def camera_config(self, cc):
        if isinstance(cc, str):
            self._camera_config = get_camera_config(cc)
        else:
            self._camera_config = cc

    def _set_camera_config(self):
        self.camera_config = self._obj.attrs["camera_config"]

    @property
    def camera_shape(self):
        if isinstance(self._obj.attrs["camera_shape"], str):
            return np.array(json.loads(self._obj.attrs["camera_shape"]))
        return np.array(self._obj.attrs["camera_shape"])

    @property
    def h_a(self):
        h_a = self._obj.attrs.get("h_a", None)
        if isinstance(h_a, str):
            h_a = json.loads(h_a)
        return h_a

    def add_xy_coords(self, xy_coord_data, coords, attrs_dict):
        """Attach 2-D coordinate rasters (xp/yp/xs/ys/lon/lat) to the object.

        Mirrors reference ``pyorc/api/orcbase.py:62-119``: each raster becomes
        a (y, x) coordinate variable with CF attrs.
        """
        obj = self._obj.copy()
        for name, data in xy_coord_data.items():
            if data is None:
                continue
            c = ndx.DataArray(
                np.asarray(data),
                dims=("y", "x"),
                name=name,
                attrs=attrs_dict.get(name, {}),
            )
            obj._coords[name] = c
        if isinstance(obj, ndx.Dataset):
            obj._sync_coords()
        return obj
