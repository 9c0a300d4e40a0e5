"""UGRID-1.0 mesh writer for QGIS (reference ``pyorc/io.py:17-138,166-312``).

A copy of :mod:`pyorc_tpu.io.ugrid` with the same global attributes, so that the two
packages' files compare equal but for ``date_created`` and ``history``. Host numpy:
the face data come down from the device with the velocimetry Dataset.
"""

from __future__ import annotations

import time as time_mod
from typing import Dict, Optional

import numpy as np

from .. import ndx
from ..geom.affine import pixel_to_map

UGRID_GLOBAL_ATTRS = {
    "source": "pyorc-tpu",
    "Conventions": "CF-1.13 UGRID-1.0",
    "title": "Surface velocimetry results from pyorc-tpu",
}

UGRID_MESH2D_ATTRS = {
    "cf_role": "mesh_topology",
    "long_name": "Topology data of 2D mesh",
    "topology_dimension": np.int32(2),
    "node_coordinates": "mesh2d_node_x mesh2d_node_y",
    "max_face_nodes_dimension": "mesh2d_nMax_face_nodes",
    "face_node_connectivity": "mesh2d_face_nodes",
    "face_dimension": "mesh2d_nFaces",
    "face_coordinates": "mesh2d_face_x mesh2d_face_y",
}

UGRID_FACE_NODES_ATTRS = {
    "cf_role": "face_node_connectivity",
    "mesh": "mesh2d",
    "location": "face",
    "long_name": "Mapping from every face to its corner nodes (counterclockwise)",
    "start_index": np.int32(0),
    "coordinates": "mesh2d_face_x mesh2d_face_y",
}

UGRID_VAR_ATTRS = {
    "mesh2d_ucx": {
        "mesh": "mesh2d",
        "location": "face",
        "standard_name": "sea_water_x_velocity",
        "long_name": "velocity, x-component",
        "units": "m s-1",
        "grid_mapping": "projected_coordinate_system",
        "coordinates": "mesh2d_face_x mesh2d_face_y",
    },
    "mesh2d_ucy": {
        "mesh": "mesh2d",
        "location": "face",
        "standard_name": "sea_water_y_velocity",
        "long_name": "velocity, y-component",
        "units": "m s-1",
        "grid_mapping": "projected_coordinate_system",
        "coordinates": "mesh2d_face_x mesh2d_face_y",
    },
    "v_s": {
        "mesh": "mesh2d",
        "location": "face",
        "standard_name": "sea_water_speed",
        "long_name": "velocity magnitude",
        "units": "m s-1",
        "grid_mapping": "projected_coordinate_system",
        "coordinates": "mesh2d_face_x mesh2d_face_y",
    },
    "s2n": {
        "mesh": "mesh2d",
        "location": "face",
        "standard_name": "noise",
        "long_name": "Signal to noise ratio",
        "units": "-",
        "grid_mapping": "projected_coordinate_system",
        "coordinates": "mesh2d_face_x mesh2d_face_y",
    },
    "corr": {
        "mesh": "mesh2d",
        "location": "face",
        "standard_name": "correlation",
        "long_name": "Correlation value",
        "units": "-",
        "grid_mapping": "projected_coordinate_system",
        "coordinates": "mesh2d_face_x mesh2d_face_y",
    },
}


def _get_mesh_face_nodes(x, y):
    node_idx = np.arange((len(x) + 1) * (len(y) + 1)).reshape(len(y) + 1, len(x) + 1)
    return np.array(
        [
            node_idx[0:-1, 0:-1].flatten(),
            node_idx[0:-1, 1:].flatten(),
            node_idx[1:, 1:].flatten(),
            node_idx[1:, 0:-1].flatten(),
        ]
    ).swapaxes(0, 1)


def to_ugrid(
    data_vars: Dict[str, np.ndarray],
    x,
    y,
    time,
    aff,
    crs=None,
    time0=None,
    title: Optional[str] = None,
    fill_na: Optional[float] = None,
) -> ndx.Dataset:
    """Assemble a UGRID-compliant Dataset from gridded face data."""
    for d in list(data_vars):
        if d not in UGRID_VAR_ATTRS:
            raise ValueError(f"Variable {d} is not in known variable keys {list(UGRID_VAR_ATTRS.keys())}")
        data_vars[d] = np.atleast_3d(np.asarray(data_vars[d], dtype=np.float64))

    mesh_face_nodes = _get_mesh_face_nodes(x, y)
    coli, rowi = np.meshgrid(np.arange(len(x)), np.arange(len(y)))
    face_x, face_y = pixel_to_map(coli, rowi, aff)
    coln, rown = np.meshgrid(np.arange(len(x) + 1), np.arange(len(y) + 1))
    node_x, node_y = pixel_to_map(coln, rown, aff)

    variables = {
        "mesh2d": ((), np.int32(0), UGRID_MESH2D_ATTRS),
        "mesh2d_face_nodes": (
            ("mesh2d_nFaces", "mesh2d_nMax_face_nodes"),
            np.int32(mesh_face_nodes),
            UGRID_FACE_NODES_ATTRS,
        ),
    }
    if crs is not None:
        from ..geom.crs import CRS

        c = CRS.from_user_input(crs)
        wkt = c.to_wkt()
        variables["projected_coordinate_system"] = ((), np.int32(0), {"wkt": wkt, "spatial_ref": wkt, "crs_wkt": wkt})

    shape = data_vars[list(data_vars.keys())[0]].shape[1:3]
    mask = np.zeros(shape)
    mask[1:-1, 1:-1] = 1
    mask = np.expand_dims(mask, axis=0)
    for var, data_var in data_vars.items():
        data_var = data_var * mask
        data_var = np.reshape(data_var, (data_var.shape[0], -1)).astype(np.float32)
        if fill_na is not None:
            data_var[np.isnan(data_var)] = fill_na
        variables[var] = (("time", "mesh2d_nFaces"), data_var, UGRID_VAR_ATTRS[var])

    attrs = dict(UGRID_GLOBAL_ATTRS)
    attrs["date_created"] = time_mod.ctime()
    attrs["history"] = f"Created by pyorc-tpu on {time_mod.ctime()}"
    if title:
        attrs["title"] = title

    ds_ugrid = ndx.Dataset(
        variables,
        coords={
            "mesh2d_node_x": (
                ("mesh2d_nNodes",),
                np.asarray(node_x).flatten(),
                {
                    "mesh": "mesh2d",
                    "location": "node",
                    "long_name": "x-coordinate of mesh nodes",
                    "standard_name": "projection_x_coordinate",
                    "units": "m",
                },
            ),
            "mesh2d_node_y": (
                ("mesh2d_nNodes",),
                np.asarray(node_y).flatten(),
                {
                    "mesh": "mesh2d",
                    "location": "node",
                    "long_name": "y-coordinate of mesh nodes",
                    "standard_name": "projection_y_coordinate",
                    "units": "m",
                },
            ),
            "mesh2d_face_x": (
                ("mesh2d_nFaces",),
                np.asarray(face_x).flatten(),
                {
                    "mesh": "mesh2d",
                    "location": "face",
                    "long_name": "x-coordinate of mesh faces",
                    "standard_name": "projection_x_coordinate",
                    "units": "m",
                },
            ),
            "mesh2d_face_y": (
                ("mesh2d_nFaces",),
                np.asarray(face_y).flatten(),
                {
                    "mesh": "mesh2d",
                    "location": "face",
                    "long_name": "y-coordinate of mesh faces",
                    "standard_name": "projection_y_coordinate",
                    "units": "m",
                },
            ),
            "time": (
                ("time",),
                np.asarray(time),
                {"long_name": "time", "standard_name": "time", "units": "seconds since 1970-01-01T00:00:00Z"},
            ),
        },
        attrs=attrs,
    )
    for k in data_vars:
        ds_ugrid.encoding[k] = {"zlib": True, "_FillValue": -9999.0}
    return ds_ugrid
