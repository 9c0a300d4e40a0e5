"""CLI parsing/validation utilities: a copy of :mod:`pyorc_tpu.cli.cli_utils`
(reference ``pyorc/cli/cli_utils.py``) on the port's classes.

GeoJSON reading replaces geopandas; recipe validation introspects the port's
method signatures exactly like the reference does. The interactive selectors
(GCPs, AOI corners, stabilization region) open matplotlib windows
(:mod:`pyorc_tpu_torch.cli.cli_elements`), imported when they are called.
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
]


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
    # exist_ok: the processes of a --num-hosts run may create the output directory together
    os.makedirs(value, exist_ok=True)
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


def validate_recipe(recipe):
    """Validate recipe sections/methods against API signatures. Reference cli_utils.py:425-475."""
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
    """Write a projected RGB sample frame as GeoTIFF. Reference :350-362."""
    from ..api.video import Video

    try:
        vid = Video(
            videofile, start_frame=frame_sample, end_frame=frame_sample + 1, camera_config=cam_config_file
        )
        frames = vid.get_frames(method="rgb")
        frames_proj = frames.frames.project(reducer="nearest")
        frames_proj.frames.to_geotiff(fn_geotiff, frame=0)
        logger.info(f"Sample geotiff written to {fn_geotiff}")
    except Exception as e:
        logger.error(f"Could not create sample geotiff. Error: {e}")


def _sample_rgb_frame(fn, frame_sample=0, rotation=None):
    from ..api.video import Video

    vid = Video(fn, start_frame=int(frame_sample), end_frame=int(frame_sample) + 1, rotation=rotation, progress=False)
    return vid.get_frame(0, method="rgb")


def get_gcps_interactive(
    fn, dst, crs=None, crs_gcps=None, frame_sample=0, rotation=None, lens_position=None, camera_matrix=None,
    dist_coeffs=None, logger=logging,
):
    """Interactive GCP selection on a sample frame. Reference :66-122."""
    from .cli_elements import GcpSelect

    img = _sample_rgb_frame(fn, frame_sample, rotation)
    if crs_gcps is not None:
        from .. import helpers

        dst = helpers.xyz_transform(dst, crs_from=crs_gcps, crs_to=4326)
    selector = GcpSelect(img, dst, crs=crs, lens_position=lens_position, logger=logger)
    src = selector.run()
    return src, selector.camera_matrix_fit, selector.dist_coeffs_fit


def get_corners_interactive(
    fn, gcps, crs=None, crs_gcps=None, frame_sample=0, camera_matrix=None, dist_coeffs=None,
    rotation=None, logger=logging,
):
    """Interactive AOI corner selection on a sample frame. Reference :22-63.

    Builds an interim CameraConfig from the already-selected GCPs (and any
    optimized intrinsics) so ``AoiSelect`` can render the live ortho-bbox
    preview the reference shows (reference ``cli_elements.py:236-359``); a
    failed interim fit degrades to plain corner clicking, never blocks it.
    """
    from .cli_elements import AoiSelect

    img = _sample_rgb_frame(fn, frame_sample, rotation)
    cam_config = _interim_camera_config(img, gcps, crs=crs, camera_matrix=camera_matrix,
                                        dist_coeffs=dist_coeffs, rotation=rotation, logger=logger)
    selector = AoiSelect(img, src=gcps.get("src"), dst=gcps.get("dst"), camera_config=cam_config, logger=logger)
    return selector.run()


def _interim_camera_config(img, gcps, crs=None, camera_matrix=None, dist_coeffs=None,
                           rotation=None, logger=logging):
    """Preliminary CameraConfig from clicked GCPs for the AOI live preview.

    Mirrors the reference's interim config (reference ``cli_utils.py:22-63``):
    height/width from the sample frame, the gcps dict as-is (its optional
    ``crs`` key reprojects dst into ``crs``), plus any optimized intrinsics
    from the GCP selector. Returns None when the fit fails (e.g. degenerate
    GCPs) so the caller can still collect corners without a preview.
    """
    from ..api.cameraconfig import CameraConfig

    try:
        gcps_cc = {k: v for k, v in gcps.items() if k in ("src", "dst", "z_0", "h_ref", "crs")}
        if gcps_cc.get("crs") is None:
            gcps_cc.pop("crs", None)
        return CameraConfig(
            height=int(img.shape[0]),
            width=int(img.shape[1]),
            crs=crs,
            gcps=gcps_cc,
            camera_matrix=camera_matrix.tolist() if hasattr(camera_matrix, "tolist") else camera_matrix,
            dist_coeffs=dist_coeffs.tolist() if hasattr(dist_coeffs, "tolist") else dist_coeffs,
            rotation=rotation,
        )
    except Exception as e:
        logger.warning(f"Could not build interim camera config for AOI preview: {e}")
        return None


def get_stabilize_pol(fn, frame_sample=0, rotation=None, logger=logging):
    """Interactive stabilization-region selection. Reference :125-131."""
    from .cli_elements import StabilizeSelect

    img = _sample_rgb_frame(fn, frame_sample, rotation)
    selector = StabilizeSelect(img, logger=logger)
    return selector.run()
