"""CLI parsing/validation utilities: a copy of :mod:`pyorc_tpu.cli.cli_utils`
(reference ``pyorc/cli/cli_utils.py``) on the port's classes.

GeoJSON reading replaces geopandas; recipe validation introspects the port's
method signatures exactly like the reference does. The interactive
selectors (GCPs, AOI corners, stabilization region; matplotlib windows in the
JAX package's ``cli_elements.py``) and the GeoTIFF export are not ported
(ROADMAP.md, queue A item 8): they raise ``NotImplementedError``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Optional

import click
import numpy as np
import yaml

from ..api.cameraconfig import load_camera_config
from ..geom import calibrate as calib
from ..geom import camera as cam_geom

__all__ = [
    "get_file_hash",
    "parse_json",
    "parse_corners",
    "validate_file",
    "validate_dir",
    "validate_rotation",
    "parse_camconfig",
    "parse_recipe",
    "parse_src",
    "parse_dst",
    "parse_str_num",
    "read_shape",
    "validate_dst",
    "validate_recipe",
    "get_gcps_optimized_fit",
    "parse_lens_params",
    "refuse_not_ported",
]

# what the interactive and export helpers say when called
_NOT_PORTED = (
    "{what} is not ported to pyorc_tpu_torch (ROADMAP.md, queue A item 8: exports, plotting and the "
    "interactive camera-config).{hint}"
)


def get_file_hash(fn):
    """SHA-256 hash of file contents (4K blocks). Reference cli_utils.py:134-143."""
    hash256 = hashlib.sha256()
    with open(fn, "rb") as f:
        for byte_block in iter(lambda: f.read(4096), b""):
            hash256.update(byte_block)
    return hash256


def get_gcps_optimized_fit(src, dst, height, width, c=2.0, camera_matrix=None, dist_coeffs=None, lens_position=None):
    """Fit intrinsics + pose on control points; return estimates and errors.

    Reference cli_utils.py:145-173.
    """
    if np.array(dst).shape == (4, 2):
        _dst = np.c_[np.array(dst), np.zeros(4)]
    else:
        _dst = np.array(dst, dtype=np.float64)
    camera_matrix, dist_coeffs, err = calib.optimize_intrinsic(
        src, _dst, height, width, c=c, lens_position=lens_position,
        camera_matrix=camera_matrix, dist_coeffs=dist_coeffs,
    )
    coord_mean = np.array(_dst).mean(axis=0)
    _src = np.float64(src)
    _dstr = np.float64(_dst - coord_mean)
    success, rvec, tvec = cam_geom.solve_pnp(_dstr, _src, np.asarray(camera_matrix), np.asarray(dist_coeffs))
    src_est = cam_geom.project_points(_dstr, rvec, tvec, np.asarray(camera_matrix), np.asarray(dist_coeffs))
    dst_est = cam_geom.unproject_to_plane(
        _src, _dstr[:, -1], rvec, tvec, np.asarray(camera_matrix), np.asarray(dist_coeffs)
    )
    dst_est = np.array(dst_est)[:, 0 : len(coord_mean)] + coord_mean
    rvec_cam, tvec_cam = cam_geom.pose_world_to_camera(rvec, tvec)
    tvec_cam = tvec_cam + coord_mean
    rvec, tvec = cam_geom.pose_world_to_camera(rvec_cam, tvec_cam)
    return src_est, dst_est, camera_matrix, dist_coeffs, rvec, tvec, err


def parse_json(ctx, param, value):
    if value is None:
        return None
    if os.path.isfile(value):
        with open(value) as f:
            return json.load(f)
    return json.loads(value)


def parse_corners(ctx, param, value):
    if value is None:
        return None
    corners = json.loads(value)
    assert np.array(corners).shape == (4, 2), "--corners must contain a list of lists [column, row] with 4 points"
    return corners


def validate_file(ctx, param, value):
    if value is not None and not os.path.isfile(value):
        raise click.FileError(f"{value}")
    return value


def validate_dir(ctx, param, value):
    if not os.path.isdir(value):
        os.makedirs(value)
    return value


def validate_rotation(ctx, param, value):
    if value is not None:
        value = int(value)
        if value not in [0, 90, 180, 270]:
            raise click.UsageError("--rotation must be either 90, 180 or 270")
    return value


def parse_camconfig(ctx, param, camconfig_file):
    """Read + validate camera config file; return as dict of strings."""
    camconfig = load_camera_config(camconfig_file)
    return camconfig.to_dict_str()


def parse_recipe(ctx, param, recipe_file):
    """Read + validate a YAML recipe."""
    with open(recipe_file, "r") as f:
        body = f.read()
    recipe = yaml.load(body, Loader=yaml.FullLoader)
    return validate_recipe(recipe)


def parse_src(ctx, param, value):
    if value is None:
        return value
    value = json.loads(value)
    if value is not None:
        assert isinstance(value, list), "--src must contain a list of lists [column, row]"
        for n, val in enumerate(value):
            assert isinstance(val, list), f"--src value {n} is not a list {val}"
            assert len(val) == 2, f"--src value {n} must contain 2 coordinates, has {len(val)}"
    return value


def parse_dst(ctx, param, value):
    if value is None:
        return value
    value = json.loads(value)
    return validate_dst(value)


def parse_str_num(ctx, param, value):
    if value is None:
        return None
    try:
        return json.loads(value)
    except (json.JSONDecodeError, TypeError):
        return value


def _crs_from_geojson(geojson: dict):
    crs = geojson.get("crs")
    if crs is None:
        return None
    name = crs.get("properties", {}).get("name", "")
    # e.g. "urn:ogc:def:crs:EPSG::32735"
    if "EPSG" in name:
        code = name.split(":")[-1]
        if code.isdigit():
            return int(code)
    return name or None


def read_shape(fn: Optional[str] = None, geojson: Optional[dict] = None):
    """Read point coordinates (+CRS) from a GeoJSON file or dict.

    Replaces the reference's geopandas-based reader (cli_utils.py:365-401);
    only Point geometries are allowed, like the reference asserts.
    """
    if fn is None and geojson is None:
        raise click.UsageError("Either fn or geojson must be provided")
    if geojson is None:
        with open(fn) as f:
            geojson = json.load(f)
    crs = _crs_from_geojson(geojson)
    feats = geojson.get("features", [])
    coords = []
    for feat in feats:
        geom = feat.get("geometry", {})
        if geom.get("type") != "Point":
            raise AssertionError('shapefile may only contain geometries of type "Point"')
        coords.append(list(geom["coordinates"]))
    if crs is None:
        click.echo("shapefile or geojson does not contain CRS, assuming CRS is the same as camera config CRS")
    return coords, crs


def validate_dst(value):
    if value is not None:
        if len(value) in [2, 4]:
            len_points = 2
        elif len(value) < 6:
            raise click.UsageError(
                f"--dst must contain exactly 2 or 4 with [x, y], or at least 6 with [x, y, z] points, "
                f"contains {len(value)}."
            )
        else:
            len_points = 3
        for n, val in enumerate(value):
            assert isinstance(val, list), f"--dst value {n} is not a list {val}"
            assert len(val) == len_points, f"--dst value {n} must contain {len_points} coordinates, value is {val}"
    return value


def refuse_not_ported(recipe: dict) -> None:
    """Raise ``NotImplementedError`` when the recipe asks for something the port does not run yet."""
    asks = ["the plot stage (api/plot.py)"] if "plot" in recipe else []
    for section in ("velocimetry", "mask"):
        if (recipe.get(section) or {}).get("write_ugrid"):
            asks.append(f"{section}.write_ugrid (io/ugrid.py)")
    for key in ("to_video", "to_geotiff"):
        if key in (recipe.get("frames") or {}):
            asks.append(f"frames.{key}")
    if asks:
        raise NotImplementedError(
            f"The recipe asks for {', '.join(asks)}, not ported to pyorc_tpu_torch yet (ROADMAP.md, queue A item 8)."
        )


def validate_recipe(recipe):
    """Validate recipe sections/methods against API signatures. Reference cli_utils.py:425-475.

    Entries the port does not run yet are refused first (:func:`refuse_not_ported`)."""
    refuse_not_ported(recipe)
    valid_classes = ["video", "water_level", "frames", "velocimetry", "mask", "transect", "stiv", "plot"]
    required_classes = ["video", "frames", "velocimetry"]
    check_args = {"video": "video", "frames": "frames"}
    process_methods = ["write"]
    for k in recipe:
        if k not in valid_classes:
            raise ValueError(f"key '{k}' is not allowed, must be one of {valid_classes}")
        for m in recipe[k]:
            if recipe[k][m] is None:
                recipe[k][m] = {}
            if m not in process_methods and k in check_args:
                if k == "video":
                    from ..api.video import Video as cls
                else:
                    from ..api.frames import Frames as cls
                if not hasattr(cls, m) and m not in cls.__init__.__code__.co_varnames:
                    raise ValueError(f"Class '{check_args[k].capitalize()}' does not have a method or property '{m}'")
                if not hasattr(cls, m):
                    continue  # __init__ kwarg, no signature check possible
                method = getattr(cls, m)
                if callable(method):
                    if "kwargs" in method.__code__.co_varnames:
                        valid_args = None
                    else:
                        valid_args = method.__code__.co_varnames[: method.__code__.co_argcount]
                    if valid_args:
                        for arg in recipe[k][m]:
                            if arg not in valid_args:
                                raise ValueError(
                                    f"Method '{check_args[k].capitalize()}.{m}' does not have input "
                                    f"argument '{arg}', must be one of {valid_args}"
                                )
    for _c in required_classes:
        if _c not in recipe:
            recipe[_c] = {}
    return recipe


# -- public-API compat (reference cli/cli_utils.py) ---------------------------


def read_shape_as_gdf(fn=None, geojson=None, gdf=None):
    """Point coordinates + CRS from a shape source (reference cli_utils.py:365-401).

    Geopandas-free build: returns (coords, crs) instead of a GeoDataFrame;
    callers in this package consume coordinate lists directly.
    """
    if gdf is not None:
        return gdf, getattr(gdf, "crs", None)
    return read_shape(fn=fn, geojson=geojson)


def parse_cross_section_gdf(ctx, param, value):
    """click callback validating a cross-section shape file (reference :339-347)."""
    if value is None:
        return None
    read_shape_as_gdf(fn=value)
    return value


def parse_lens_params(height, width, focal_length=None, k1=None, k2=None):
    """Lens parameters -> (camera_matrix, dist_coeffs). Reference :206-226."""
    from ..geom.calibrate import DIST_COEFFS, get_cam_mtx

    camera_matrix = None
    if focal_length is not None:
        camera_matrix = get_cam_mtx(height, width, c=2.0, focal_length=focal_length)
    dist_coeffs = None
    if k1 is not None or k2 is not None:
        dist_coeffs = [list(row) for row in DIST_COEFFS]
        if k1 is not None:
            dist_coeffs[0][0] = k1
        if k2 is not None:
            dist_coeffs[1][0] = k2
    return camera_matrix, dist_coeffs


def parse_geotiff(videofile, cam_config_file, fn_geotiff, frame_sample=0, logger=logging):
    """Write a projected RGB sample frame as GeoTIFF (reference :350-362). Not ported."""
    raise NotImplementedError(_NOT_PORTED.format(what="The GeoTIFF export", hint=""))


def get_gcps_interactive(fn, dst, **kwargs):
    """Interactive GCP selection on a sample frame (reference :66-122). Not ported."""
    raise NotImplementedError(_NOT_PORTED.format(what="Interactive GCP selection", hint=" Pass --src."))


def get_corners_interactive(fn, gcps, **kwargs):
    """Interactive AOI corner selection on a sample frame (reference :22-63). Not ported."""
    raise NotImplementedError(_NOT_PORTED.format(what="Interactive AOI corner selection", hint=" Pass --corners."))


def get_stabilize_pol(fn, frame_sample=0, rotation=None, logger=logging):
    """Interactive stabilization-region selection (reference :125-131). Not ported."""
    raise NotImplementedError(
        _NOT_PORTED.format(what="Interactive stabilization-region selection", hint=" Leave out --stabilize.")
    )
