"""Intrinsic self-calibration from GCPs and incremental pose rotation fitting.

Mirrors reference ``pyorc/cv.py:1086-1273`` (optimize_intrinsic: differential
evolution over focal length and k1/k2 against GCP reprojection error, with
lens-position term at 10% weight and a radial-monotonicity penalty) and
``pyorc/cv.py:1276-1360`` (find_rotation_points / rotate_pose).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np
from scipy import optimize

from . import camera as cam

__all__ = ["optimize_intrinsic", "find_rotation_points", "rotate_pose", "get_cam_mtx", "DIST_COEFFS"]

DIST_COEFFS = [[0.0], [0.0], [0.0], [0.0], [0.0]]


def get_cam_mtx(height: int, width: int, c: float = 2.0, focal_length: Optional[float] = None) -> np.ndarray:
    """Default camera matrix: principal point at (width/c, height/c), f = width unless given."""
    mtx = np.eye(3, dtype=np.float64)
    mtx[0, 2] = width / c
    mtx[1, 2] = height / c
    f = width if focal_length is None else focal_length
    mtx[0, 0] = f
    mtx[1, 1] = f
    return mtx


def _radial_monotonicity_penalty(k1: float, k2: float, r_max: float) -> float:
    rs = np.linspace(0, r_max, 50)
    deriv = 1 + 3 * k1 * rs**2 + 5 * k2 * rs**4
    return float(np.sum(np.clip(-deriv, 0, None)))


def optimize_intrinsic(
    src,
    dst,
    height: int,
    width: int,
    c: float = 2.0,
    lens_position=None,
    camera_matrix=None,
    dist_coeffs=None,
) -> Tuple[np.ndarray, list, Optional[float]]:
    """Fit focal length (+ k1, k2 when >4 GCPs) by minimizing GCP reprojection error."""

    def error_intrinsic(x):
        param_nr = 0
        if camera_matrix is None:
            f = x[param_nr] * width
            cm = get_cam_mtx(height, width, c=c, focal_length=f)
            param_nr += 1
        else:
            cm = np.asarray(camera_matrix, dtype=np.float64)
        if dist_coeffs is None and len(dst) > 4:
            dc = np.zeros(5)
            k1, k2 = x[param_nr], x[param_nr + 1]
            dc[0], dc[1] = k1, k2
            fx, fy = cm[0, 2], cm[1, 2]
            r_max = np.sqrt(fx**2 + fy**2) * cm[0, 0]
            penalty = _radial_monotonicity_penalty(k1, k2, r_max)
        else:
            dc = np.asarray(dist_coeffs if dist_coeffs is not None else DIST_COEFFS, dtype=np.float64).ravel()
            penalty = 0.0

        err = 100.0
        coord_mean = np.asarray(dst, dtype=np.float64).mean(axis=0)
        _dst = np.asarray(dst, dtype=np.float64) - coord_mean
        zs = np.zeros(len(_dst)) if _dst.shape[1] == 2 else _dst[:, -1]
        success, rvec, tvec = cam.solve_pnp(_dst, src, cm, dc)
        if success:
            dst_est = cam.unproject_to_plane(np.asarray(src, dtype=np.float64), zs, rvec, tvec, cm, dc)
            dist_xy = _dst[:, 0:2] - dst_est[:, 0:2]
            gcp_err = float(np.sqrt((dist_xy**2).sum(axis=1)).mean())
            cam_err = None
            if lens_position is not None:
                lp = np.asarray(lens_position, dtype=np.float64) - coord_mean
                lens_pos2 = cam.camera_position(rvec, tvec)
                cam_err = float(np.sqrt(((lp - lens_pos2) ** 2).sum()))
            err = 0.1 * cam_err + gcp_err if cam_err is not None else gcp_err
        return err + 100 * penalty

    bounds = []
    if camera_matrix is not None and dist_coeffs is not None:
        return camera_matrix, dist_coeffs, None
    if camera_matrix is None:
        bounds.append([0.25, 2.0])
    if len(dst) > 4 and dist_coeffs is None:
        bounds.append([-0.5, 0.5])  # k1
        bounds.append([-0.1, 0.1])  # k2
    elif len(dst) <= 4:
        if dist_coeffs:
            warnings.warn(
                "Optimizing distortion with only 4 GCPs would overfit; setting distortion to zero.",
                stacklevel=2,
            )
        dist_coeffs = [list(r) for r in DIST_COEFFS]
    opt = optimize.differential_evolution(error_intrinsic, bounds=bounds, atol=0.001, seed=0)
    param_nr = 0
    if camera_matrix is None:
        camera_matrix = get_cam_mtx(height, width, focal_length=opt.x[param_nr] * width)
        param_nr += 1
    if dist_coeffs is None:
        dist_coeffs = [list(r) for r in DIST_COEFFS]
        dist_coeffs[0][0] = float(opt.x[param_nr])
        dist_coeffs[1][0] = float(opt.x[param_nr + 1])
    return camera_matrix, dist_coeffs, float(opt.fun)


def find_rotation_points(src, dst, camera_matrix, dist_coeffs=None) -> Tuple[np.ndarray, np.ndarray]:
    """Incremental rotation between two point sets on the image (Kabsch on bearing rays)."""
    norm_old = cam.undistort_points(src, camera_matrix, dist_coeffs, P=None)
    norm_new = cam.undistort_points(dst, camera_matrix, dist_coeffs, P=None)
    rays_old = np.hstack([norm_old.reshape(-1, 2), np.ones((len(norm_old), 1))])
    rays_new = np.hstack([norm_new.reshape(-1, 2), np.ones((len(norm_new), 1))])
    H = rays_old.T @ rays_new
    U, S, Vt = np.linalg.svd(H)
    R_delta = Vt.T @ U.T
    if np.linalg.det(R_delta) < 0:
        Vt[-1, :] *= -1
        R_delta = Vt.T @ U.T
    predicted = (R_delta @ rays_old.T).T
    error = np.linalg.norm(predicted - rays_new, axis=1)
    return cam.rodrigues_inv(R_delta).reshape(3, 1), error


def rotate_pose(rvec, tvec, delta_rvec) -> Tuple[list, list]:
    """Apply incremental rotation to a pose (tvec co-rotates). Reference pyorc/cv.py:1325-1360."""
    R_old = cam.rodrigues(np.asarray(rvec, dtype=np.float64).ravel())
    R_delta = cam.rodrigues(np.asarray(delta_rvec, dtype=np.float64).ravel())
    R_new = R_delta @ R_old
    rvec_new = cam.rodrigues_inv(R_new)
    _, tvec_cam = cam.pose_world_to_camera(np.asarray(rvec, dtype=np.float64), np.asarray(tvec, dtype=np.float64))
    rvec_new, tvec_new = cam.pose_world_to_camera(-rvec_new, tvec_cam)
    return rvec_new.flatten().tolist(), tvec_new.flatten().tolist()
