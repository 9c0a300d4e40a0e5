"""Pinhole camera model: Rodrigues, Brown–Conrady distortion, projection,
plane unprojection, homographies, PnP (P3P + iterative LM), affine fits, and
Zhang camera calibration.

This is an original implementation of the geometric machinery the reference
gets from OpenCV C++ (reference call sites: ``pyorc/cv.py:505-546`` solvepnp,
``:675-690`` _Rt_to_M, ``:726-766`` distort_points, ``:1416-1469``
unproject_points, ``:1472-1507`` undistort_points, ``:769-831`` homographies).
Everything is float64 numpy on the host — poses and sampling grids are
computed once per video, then consumed by the device kernels.

The ``*_tensor`` functions are the per-point functions on float64 tensors on
their device (the ortho index maps are built on the card), bit for bit the
host's values: each expression is written in the host function's evaluation
order. numpy's ``@`` of an (N, 3) by a 3x3 array (:func:`_points_times`)
runs through BLAS, which on FMA hardware rounds each dot product as a chain
of fused multiply-adds over k = 0, 1, 2, and elsewhere rounds each product
and sum; :func:`host_blas_rule` finds which at first use, and the twins give
that rounding with plain float64 operations (the chain through
:func:`pyorc_tpu_torch._fma.fma`), never a matmul or a fused op of their own.
Rotations, ``K`` and homographies are still made on the host and enter as
Python floats. A tensor is divided only by a tensor on its own device: CUDA
divides by a Python scalar as a multiply by its reciprocal, which may round
differently from the host's division.

Conventions (OpenCV-compatible so reference camera-config JSONs load
unchanged):
- pixel coordinates are (x=column, y=row)
- ``rvec``/``tvec`` map world -> camera: ``P_cam = R @ P_world + t``
- distortion coefficients ``(k1, k2, p1, p2[, k3[, k4, k5, k6]])``
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from .._fma import fma as _fma

logger = logging.getLogger(__name__)

__all__ = [
    "rodrigues",
    "rodrigues_inv",
    "distort_normalized",
    "undistort_normalized",
    "project_points",
    "undistort_points",
    "distort_points",
    "unproject_to_plane",
    "homography_from_pose",
    "get_perspective_transform",
    "perspective_transform",
    "solve_pnp",
    "solve_p3p",
    "solve_pnp_iterative",
    "refine_pose_lm",
    "estimate_affine_partial_2d",
    "estimate_affine_2d",
    "calibrate_camera_zhang",
    "camera_position",
    "world_to_camera",
    "pose_world_to_camera",
    "distort_normalized_tensor",
    "undistort_normalized_tensor",
    "project_points_tensor",
    "undistort_points_tensor",
    "perspective_transform_tensor",
    "unproject_to_plane_tensor",
]


# ----------------------------------------------------------------------------------
# Rotations
# ----------------------------------------------------------------------------------


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Rotation vector (axis*angle) -> 3x3 rotation matrix."""
    r = np.asarray(rvec, dtype=np.float64).reshape(3)
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def rodrigues_inv(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> rotation vector."""
    R = np.asarray(R, dtype=np.float64)
    cos_theta = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-12:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        # near-pi: extract axis from R + I
        A = (R + np.eye(3)) / 2
        k = np.sqrt(np.maximum(np.diag(A), 0))
        # fix signs using off-diagonals
        i = int(np.argmax(k))
        if k[i] > 0:
            k = A[:, i] / k[i]
        k /= np.linalg.norm(k)
        return k * theta
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / (2 * np.sin(theta))
    return axis * theta


# ----------------------------------------------------------------------------------
# Distortion
# ----------------------------------------------------------------------------------


def _dist8(dist_coeffs) -> np.ndarray:
    """Normalize distortion coefficients to length-8 (k1 k2 p1 p2 k3 k4 k5 k6)."""
    if dist_coeffs is None:
        return np.zeros(8)
    d = np.asarray(dist_coeffs, dtype=np.float64).ravel()
    out = np.zeros(8)
    out[: len(d)] = d
    return out


def distort_normalized(pts: np.ndarray, dist_coeffs) -> np.ndarray:
    """Apply Brown–Conrady (+ rational) distortion to normalized image points (N,2)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = _dist8(dist_coeffs)
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def undistort_normalized(pts: np.ndarray, dist_coeffs, iterations: int = 5) -> np.ndarray:
    """Invert Brown–Conrady distortion via fixed-point iteration.

    The default of 5 iterations matches OpenCV's undistortPoints exactly.
    This matters beyond speed: for strong barrel distortion the model is not
    invertible near the image corners, and downstream behaviour (reference
    parity) depends on the truncated iteration landing where OpenCV lands.
    """
    k1, k2, p1, p2, k3, k4, k5, k6 = _dist8(dist_coeffs)
    xd, yd = pts[..., 0], pts[..., 1]
    x, y = xd.copy(), yd.copy()
    for _ in range(iterations):
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return np.stack([x, y], axis=-1)


# ----------------------------------------------------------------------------------
# Projection
# ----------------------------------------------------------------------------------


def project_points(
    points: np.ndarray,
    rvec: np.ndarray,
    tvec: np.ndarray,
    camera_matrix: np.ndarray,
    dist_coeffs=None,
) -> np.ndarray:
    """World 3-D points (N,3) -> distorted pixel coordinates (N,2)."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    R = rodrigues(rvec)
    t = np.asarray(tvec, dtype=np.float64).reshape(3)
    pc = _points_times(pts, R) + t
    z = pc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        xn = pc[:, 0] / z
        yn = pc[:, 1] / z
    nd = distort_normalized(np.stack([xn, yn], axis=-1), dist_coeffs)
    K = np.asarray(camera_matrix, dtype=np.float64)
    u = K[0, 0] * nd[..., 0] + K[0, 1] * nd[..., 1] + K[0, 2]
    v = K[1, 1] * nd[..., 1] + K[1, 2]
    return np.stack([u, v], axis=-1)


def undistort_points(points, camera_matrix, dist_coeffs, P: Optional[np.ndarray] = "same") -> np.ndarray:
    """Distorted pixel coords -> undistorted (pixel coords if P else normalized)."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    K = np.asarray(camera_matrix, dtype=np.float64)
    xn = (pts[:, 0] - K[0, 2]) / K[0, 0]
    yn = (pts[:, 1] - K[1, 2]) / K[1, 1]
    und = undistort_normalized(np.stack([xn, yn], axis=-1), dist_coeffs)
    if P is None:
        return und
    Pm = K if (isinstance(P, str) and P == "same") else np.asarray(P, dtype=np.float64)
    u = Pm[0, 0] * und[:, 0] + Pm[0, 2]
    v = Pm[1, 1] * und[:, 1] + Pm[1, 2]
    return np.stack([u, v], axis=-1)


def distort_points(points, camera_matrix, dist_coeffs, norm: bool = False) -> np.ndarray:
    """Undistorted pixel coords (or normalized if norm) -> distorted pixel coords."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    K = np.asarray(camera_matrix, dtype=np.float64)
    if not norm:
        xn = (pts[:, 0] - K[0, 2]) / K[0, 0]
        yn = (pts[:, 1] - K[1, 2]) / K[1, 1]
        nd = np.stack([xn, yn], axis=-1)
    else:
        nd = pts
    dd = distort_normalized(nd, dist_coeffs)
    u = K[0, 0] * dd[:, 0] + K[0, 2]
    v = K[1, 1] * dd[:, 1] + K[1, 2]
    return np.stack([u, v], axis=-1)


def homography_from_pose(rvec, tvec, camera_matrix, z: float = 0.0, reverse: bool = False) -> np.ndarray:
    """Homography between the world plane at elevation ``z`` and the (undistorted) image.

    reverse=False maps image -> world-plane (x, y); reverse=True maps world -> image.
    Matches the construction at reference ``pyorc/cv.py:675-690``.
    """
    R = rodrigues(rvec)
    t = np.asarray(tvec, dtype=np.float64).reshape(3)
    H = R.copy()
    H[:, 2] = R[:, 2] * z + t
    K = np.asarray(camera_matrix, dtype=np.float64)
    M = K @ H
    if not reverse:
        M = np.linalg.inv(M)
    return M / M[-1, -1]


def perspective_transform(points, M) -> np.ndarray:
    """Apply 3x3 homography to (N,2) points."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    h = _points_times(np.concatenate([pts, np.ones((len(pts), 1))], axis=1), np.asarray(M, dtype=np.float64))
    return h[:, :2] / h[:, 2:3]


def get_perspective_transform(src, dst) -> np.ndarray:
    """Exact 4-point homography (DLT), src (4,2) -> dst (4,2)."""
    src = np.asarray(src, dtype=np.float64).reshape(4, 2)
    dst = np.asarray(dst, dtype=np.float64).reshape(4, 2)
    A = []
    b = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.extend([u, v])
    h = np.linalg.solve(np.asarray(A), np.asarray(b))
    return np.append(h, 1.0).reshape(3, 3)


def unproject_to_plane(points, z, rvec, tvec, camera_matrix, dist_coeffs=None) -> np.ndarray:
    """Pixel coords (N,2) + plane elevation(s) z -> world (N,3).

    Mirrors reference ``pyorc/cv.py:1416-1469``: undistort, then apply the
    plane homography. Vectorized over per-point z.
    """
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    und = undistort_points(pts, camera_matrix, dist_coeffs, P="same")
    zs = np.broadcast_to(np.asarray(z, dtype=np.float64), (len(pts),))
    R = rodrigues(rvec)
    t = np.asarray(tvec, dtype=np.float64).reshape(3)
    K = np.asarray(camera_matrix, dtype=np.float64)
    if np.all(zs == zs.flat[0]):
        M = homography_from_pose(rvec, tvec, K, z=float(zs.flat[0]), reverse=False)
        xy = perspective_transform(und, M)
        return np.column_stack([xy, zs])
    # varying z: solve the ray/plane intersection per point (vectorized)
    # ray direction in world coords for each undistorted pixel
    xn = (und[:, 0] - K[0, 2]) / K[0, 0]
    yn = (und[:, 1] - K[1, 2]) / K[1, 1]
    d_cam = np.stack([xn, yn, np.ones_like(xn)], axis=-1)
    Rt = R.T
    d_world = d_cam @ Rt.T
    c_world = -Rt @ t  # camera centre
    lam = (zs - c_world[2]) / d_world[:, 2]
    out = c_world[None, :] + lam[:, None] * d_world
    return out


# ----------------------------------------------------------------------------------
# Tensor twins (float64, the host functions' evaluation order)
# ----------------------------------------------------------------------------------


def _floats(a) -> list:
    return [float(v) for v in np.asarray(a, dtype=np.float64).ravel()]


def _points_times(pts: np.ndarray, m: np.ndarray) -> np.ndarray:
    """The host's product of points (N, 3) by a 3x3 matrix, ``pts @ m.T``, through numpy's BLAS."""
    return pts @ m.T


_BLAS_RULE: Optional[str] = None  # host_blas_rule's answer, found at first use


def host_blas_rule() -> str:
    """How the host's :func:`_points_times` rounds a term ``x m0 + y m1 + z m2``: ``"fma"`` (a chain
    of fused multiply-adds over k = 0, 1, 2, as an FMA BLAS does) or ``"plain"`` (each product and
    sum rounded). Found once, from a near-tie: with ``a = 1 + 2**-27``, ``a * a`` rounds off
    ``2**-54``, which the chain ``fma(a, -a, a * a)`` keeps and plain products cancel. The probe
    takes (64, 3) points, the matrix-by-matrix path of the maps' products (numpy sends one row
    through another BLAS routine). Logged; an answer that is neither is logged as a warning and the
    twins keep the chain."""
    global _BLAS_RULE
    if _BLAS_RULE is None:
        a = 1.0 + 2.0**-27
        m = np.array([[a, -a, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
        got = set(_points_times(np.tile([a, a, 0.0], (64, 1)), m)[:, 0].tolist())
        rule = {(-(2.0**-54),): "fma", (0.0,): "plain"}.get(tuple(got))
        if rule is None:
            logger.warning("numpy's 3x3 products round the near-tie probe to %s, neither an FMA chain nor "
                           "plain products: the ortho maps built as tensors may differ from the host's in "
                           "their last bits (the twins keep the FMA chain)", sorted(got))
            rule = "fma"
        else:
            logger.info("numpy's 3x3 products round as %s: the ortho-map twins follow", rule)
        _BLAS_RULE = rule
    return _BLAS_RULE


def _dot3(x, y, z, r) -> torch.Tensor:
    """``x r[0] + y r[1] + z r[2]`` rounded as one term of the host's :func:`_points_times`, by the
    rule :func:`host_blas_rule` found."""
    if host_blas_rule() == "plain":
        return (x * r[0] + y * r[1]) + z * r[2]
    return _fma(z, r[2], _fma(y, r[1], x * r[0]))


def _over(num: torch.Tensor, den: float) -> torch.Tensor:
    """``num / den`` as a true division on the card (see the module docstring)."""
    return num / torch.tensor(den, dtype=torch.float64, device=num.device)


def _distort_xy(x, y, d):
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def _undistort_xy(xd, yd, d, iterations):
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    x, y = xd, yd
    for _ in range(iterations):
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return x, y


def _undistort_pixels_xy(u, v, camera_matrix, dist_coeffs, P="same"):
    K = np.asarray(camera_matrix, dtype=np.float64)
    xn = _over(u - float(K[0, 2]), float(K[0, 0]))
    yn = _over(v - float(K[1, 2]), float(K[1, 1]))
    x, y = _undistort_xy(xn, yn, _floats(_dist8(dist_coeffs)), 5)
    if P is None:
        return x, y
    Pm = K if (isinstance(P, str) and P == "same") else np.asarray(P, dtype=np.float64)
    return float(Pm[0, 0]) * x + float(Pm[0, 2]), float(Pm[1, 1]) * y + float(Pm[1, 2])


def _homography_xy(x, y, M):
    m = np.asarray(M, dtype=np.float64)
    h = [_dot3(x, y, 1.0, _floats(m[i])) for i in range(3)]
    return h[0] / h[2], h[1] / h[2]


def distort_normalized_tensor(pts: torch.Tensor, dist_coeffs) -> torch.Tensor:
    """:func:`distort_normalized` on a float64 tensor [..., 2]."""
    pts = pts.to(torch.float64)
    return torch.stack(_distort_xy(pts[..., 0], pts[..., 1], _floats(_dist8(dist_coeffs))), dim=-1)


def undistort_normalized_tensor(pts: torch.Tensor, dist_coeffs, iterations: int = 5) -> torch.Tensor:
    """:func:`undistort_normalized` on a float64 tensor [..., 2]."""
    pts = pts.to(torch.float64)
    return torch.stack(_undistort_xy(pts[..., 0], pts[..., 1], _floats(_dist8(dist_coeffs)), iterations), dim=-1)


def project_points_tensor(points: torch.Tensor, rvec, tvec, camera_matrix, dist_coeffs=None) -> torch.Tensor:
    """:func:`project_points` on a float64 tensor [N, 3] -> [N, 2]."""
    pts = points.to(torch.float64).reshape(-1, 3)
    R = rodrigues(rvec)
    t = _floats(tvec)
    X, Y, Z = pts[:, 0], pts[:, 1], pts[:, 2]
    pc = [_dot3(X, Y, Z, _floats(R[i])) + t[i] for i in range(3)]
    xd, yd = _distort_xy(pc[0] / pc[2], pc[1] / pc[2], _floats(_dist8(dist_coeffs)))
    K = np.asarray(camera_matrix, dtype=np.float64)
    u = float(K[0, 0]) * xd + float(K[0, 1]) * yd + float(K[0, 2])
    v = float(K[1, 1]) * yd + float(K[1, 2])
    return torch.stack([u, v], dim=-1)


def undistort_points_tensor(points: torch.Tensor, camera_matrix, dist_coeffs, P: Optional[np.ndarray] = "same") -> torch.Tensor:
    """:func:`undistort_points` on a float64 tensor [N, 2]."""
    pts = points.to(torch.float64).reshape(-1, 2)
    return torch.stack(_undistort_pixels_xy(pts[:, 0], pts[:, 1], camera_matrix, dist_coeffs, P), dim=-1)


def perspective_transform_tensor(points: torch.Tensor, M) -> torch.Tensor:
    """:func:`perspective_transform` on a float64 tensor [N, 2]."""
    pts = points.to(torch.float64).reshape(-1, 2)
    return torch.stack(_homography_xy(pts[:, 0], pts[:, 1], M), dim=-1)


def unproject_to_plane_tensor(points: torch.Tensor, z: float, rvec, tvec, camera_matrix, dist_coeffs=None) -> torch.Tensor:
    """:func:`unproject_to_plane` on a float64 tensor [N, 2] at one plane elevation ``z`` -> [N, 3].

    The host's constant-z branch: undistort, then the plane homography made
    on the host by :func:`homography_from_pose`.
    """
    pts = points.to(torch.float64).reshape(-1, 2)
    u, v = _undistort_pixels_xy(pts[:, 0], pts[:, 1], camera_matrix, dist_coeffs)
    M = homography_from_pose(rvec, tvec, np.asarray(camera_matrix, dtype=np.float64), z=float(z), reverse=False)
    x, y = _homography_xy(u, v, M)
    return torch.stack([x, y, torch.full_like(x, float(z))], dim=-1)


def camera_position(rvec, tvec) -> np.ndarray:
    """Camera centre in world coordinates."""
    R = rodrigues(rvec)
    return -R.T @ np.asarray(tvec, dtype=np.float64).reshape(3)


def world_to_camera(points, rvec, tvec) -> np.ndarray:
    """World points (N,3) -> camera-frame points (N,3). Reference pyorc/cv.py:1510."""
    R = rodrigues(rvec)
    return np.asarray(points, dtype=np.float64).reshape(-1, 3) @ R.T + np.asarray(tvec).reshape(3)


def pose_world_to_camera(rvec, tvec) -> Tuple[np.ndarray, np.ndarray]:
    """Invert a pose (world->camera becomes camera->world). Reference pyorc/cv.py:693-723."""
    R = rodrigues(np.asarray(rvec).ravel())
    Rt = R.T
    t_new = -Rt @ np.asarray(tvec, dtype=np.float64).ravel()
    return rodrigues_inv(Rt), t_new


# ----------------------------------------------------------------------------------
# PnP
# ----------------------------------------------------------------------------------


def solve_p3p(obj_pts: np.ndarray, img_pts: np.ndarray, camera_matrix, dist_coeffs=None) -> List[Tuple[np.ndarray, np.ndarray]]:
    """All P3P solutions for exactly 3 correspondences (Grunert's method).

    Returns a list of (rvec, tvec) candidates; each reprojects the three
    points exactly (up to numerics).
    """
    P = np.asarray(obj_pts, dtype=np.float64).reshape(3, 3)
    # bearing vectors from undistorted normalized coords
    und = undistort_points(img_pts, camera_matrix, dist_coeffs, P=None)
    f = np.concatenate([und, np.ones((3, 1))], axis=1)
    f = f / np.linalg.norm(f, axis=1, keepdims=True)

    aa = float(np.sum((P[1] - P[2]) ** 2))  # |P2-P3|^2
    bb = float(np.sum((P[0] - P[2]) ** 2))  # |P1-P3|^2
    cc = float(np.sum((P[0] - P[1]) ** 2))  # |P1-P2|^2
    ca = float(f[1] @ f[2])  # cos(alpha): angle opposite side a
    cb = float(f[0] @ f[2])
    cg = float(f[0] @ f[1])

    # Grunert quartic in v = s3/s1 (derived symbolically; see repo history)
    A4 = aa**2 - 2 * aa * bb - 2 * aa * cc + bb**2 - 4 * bb * ca**2 * cc + 2 * bb * cc + cc**2
    A3 = (
        -4 * aa**2 * cb
        + 4 * aa * bb * ca * cg
        + 4 * aa * bb * cb
        + 8 * aa * cb * cc
        - 4 * bb**2 * ca * cg
        + 8 * bb * ca**2 * cb * cc
        + 4 * bb * ca * cc * cg
        - 4 * bb * cb * cc
        - 4 * cb * cc**2
    )
    A2 = (
        4 * aa**2 * cb**2
        + 2 * aa**2
        - 8 * aa * bb * ca * cb * cg
        - 4 * aa * bb * cg**2
        - 8 * aa * cb**2 * cc
        - 4 * aa * cc
        + 4 * bb**2 * ca**2
        + 4 * bb**2 * cg**2
        - 2 * bb**2
        - 4 * bb * ca**2 * cc
        - 8 * bb * ca * cb * cc * cg
        + 4 * cb**2 * cc**2
        + 2 * cc**2
    )
    A1 = (
        -4 * aa**2 * cb
        + 4 * aa * bb * ca * cg
        + 8 * aa * bb * cb * cg**2
        - 4 * aa * bb * cb
        + 8 * aa * cb * cc
        - 4 * bb**2 * ca * cg
        + 4 * bb * ca * cc * cg
        + 4 * bb * cb * cc
        - 4 * cb * cc**2
    )
    A0 = aa**2 - 4 * aa * bb * cg**2 + 2 * aa * bb - 2 * aa * cc + bb**2 - 2 * bb * cc + cc**2

    roots = np.roots([A4, A3, A2, A1, A0])
    sols = []
    for v in roots:
        if abs(v.imag) > 1e-8 * max(1.0, abs(v.real)):
            continue
        v = float(v.real)
        if v <= 0:
            continue
        denom = 1 + v**2 - 2 * v * cb
        if denom <= 0:
            continue
        s1 = np.sqrt(bb / denom)
        # u from the cc/bb equation: u^2 - 2 cg u + (1 - cc/(bb/denom... )) careful:
        # cc = s1^2 (1 + u^2 - 2 u cg)  =>  u^2 - 2 cg u + 1 - cc/s1^2 = 0
        c0 = 1 - cc / (s1 * s1)
        disc = cg * cg - c0
        if disc < 0:
            continue
        for u in (cg + np.sqrt(disc), cg - np.sqrt(disc)):
            if u <= 0:
                continue
            # check against aa equation
            res = aa - s1**2 * (u**2 + v**2 - 2 * u * v * ca)
            if abs(res) > 1e-4 * max(aa, 1.0):
                continue
            s = np.array([s1, u * s1, v * s1])
            p_cam = f * s[:, None]
            Rt_pose = _kabsch(P, p_cam)
            if Rt_pose is None:
                continue
            R, t = Rt_pose
            sols.append((rodrigues_inv(R), t))
    # dedupe near-identical solutions
    unique: List[Tuple[np.ndarray, np.ndarray]] = []
    for rv, tv in sols:
        if not any(
            np.allclose(rv, rv2, rtol=0, atol=1e-6) and np.allclose(tv, tv2, rtol=0, atol=1e-6)
            for rv2, tv2 in unique
        ):
            unique.append((rv, tv))
    return unique


def _kabsch(P_world: np.ndarray, P_cam: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Rigid transform world->camera from 3+ paired points (Kabsch/Umeyama)."""
    cw = P_world.mean(axis=0)
    cc_ = P_cam.mean(axis=0)
    H = (P_world - cw).T @ (P_cam - cc_)
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    if not np.isfinite(R).all():
        return None
    t = cc_ - R @ cw
    return R, t


def _reproj_error(obj, img, rvec, tvec, K, dist) -> float:
    proj = project_points(obj, rvec, tvec, K, dist)
    return float(np.sqrt(np.mean(np.sum((proj - img) ** 2, axis=1))))


def solve_pnp(
    dst,
    src,
    camera_matrix,
    dist_coeffs=None,
    flags: Optional[str] = None,
) -> Tuple[bool, np.ndarray, np.ndarray]:
    """PnP dispatch mirroring reference semantics (pyorc/cv.py:505-546):

    4 points -> P3P on points 1-3, disambiguated by the 4th;
    otherwise -> DLT/EPnP-style init + Levenberg-Marquardt refinement.

    Returns (success, rvec (3,1), tvec (3,1)).
    """
    obj = np.asarray(dst, dtype=np.float64).reshape(-1, 3) if np.asarray(dst).ndim > 1 and np.asarray(dst).shape[-1] == 3 else None
    if obj is None:
        arr = np.asarray(dst, dtype=np.float64).reshape(-1, 2)
        obj = np.column_stack([arr, np.zeros(len(arr))])
    img = np.asarray(src, dtype=np.float64).reshape(-1, 2)
    K = np.asarray(camera_matrix, dtype=np.float64)

    n = len(obj)
    if flags is None:
        flags = "p3p" if n == 4 else "iterative"
    if flags == "p3p":
        if n != 4:
            raise ValueError("P3P requires exactly 4 points")
        cands = solve_p3p(obj[:3], img[:3], K, dist_coeffs)
        if not cands:
            return False, np.zeros((3, 1)), np.zeros((3, 1))
        errs = [_reproj_error(obj[3:4], img[3:4], rv, tv, K, dist_coeffs) for rv, tv in cands]
        rv, tv = cands[int(np.argmin(errs))]
        return True, rv.reshape(3, 1), tv.reshape(3, 1)
    # iterative: init + LM over all points
    rv0, tv0 = _pnp_init(obj, img, K, dist_coeffs)
    rv, tv = refine_pose_lm(obj, img, K, dist_coeffs, rv0, tv0)
    return True, rv.reshape(3, 1), tv.reshape(3, 1)


def _pnp_init(obj, img, K, dist) -> Tuple[np.ndarray, np.ndarray]:
    """Initial pose: planar homography decomposition or DLT depending on geometry."""
    und = undistort_points(img, K, dist, P=None)  # normalized
    # check planarity
    centered = obj - obj.mean(axis=0)
    _, S, Vt = np.linalg.svd(centered)
    planar = S[2] < 1e-6 * max(S[0], 1.0)
    if planar:
        normal = Vt[2]
        # build plane frame
        u_ax = Vt[0]
        v_ax = Vt[1]
        origin = obj.mean(axis=0)
        uv = np.stack([(obj - origin) @ u_ax, (obj - origin) @ v_ax], axis=-1)
        H = _dlt_homography(uv, und)
        # decompose H = [r1 r2 t]
        h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
        lam = 1.0 / np.linalg.norm(h1)
        r1 = h1 * lam
        r2 = h2 * lam
        r2 = r2 - (r1 @ r2) * r1
        r2 /= np.linalg.norm(r2)
        r3 = np.cross(r1, r2)
        Rp = np.stack([r1, r2, r3], axis=1)
        tp = h3 * lam
        # ensure positive depth
        if tp[2] < 0:
            Rp[:, 0] *= -1
            Rp[:, 1] *= -1
            tp = -tp
        # compose with plane frame: P_cam = Rp @ [u, v, 0] + tp, with [u,v] = A(P_world)
        A = np.stack([u_ax, v_ax, np.cross(u_ax, v_ax)], axis=0)  # world->plane
        R = Rp @ A
        t = tp - R @ origin
        # re-orthogonalize
        U, _, Vt2 = np.linalg.svd(R)
        R = U @ Vt2
        return rodrigues_inv(R), t
    # DLT for full 3-D configurations (needs >= 6 points)
    n = len(obj)
    A = np.zeros((2 * n, 12))
    for i, ((X, Y, Z), (x, y)) in enumerate(zip(obj, und)):
        A[2 * i] = [X, Y, Z, 1, 0, 0, 0, 0, -x * X, -x * Y, -x * Z, -x]
        A[2 * i + 1] = [0, 0, 0, 0, X, Y, Z, 1, -y * X, -y * Y, -y * Z, -y]
    _, _, Vt3 = np.linalg.svd(A)
    Pm = Vt3[-1].reshape(3, 4)
    R_est = Pm[:, :3]
    U, S, Vt4 = np.linalg.svd(R_est)
    scale = np.mean(S)
    R = U @ Vt4
    if np.linalg.det(R) < 0:
        R = -R
        scale = -scale
    t = Pm[:, 3] / scale
    # positive depth check
    if np.mean((obj @ R.T + t)[:, 2]) < 0:
        R = -R  # flip not rigid; instead redo with negated P
        Pm = -Pm
        R_est = Pm[:, :3]
        U, S, Vt4 = np.linalg.svd(R_est)
        scale = np.mean(S)
        R = U @ Vt4
        if np.linalg.det(R) < 0:
            R, scale = -R, -scale
        t = Pm[:, 3] / scale
    return rodrigues_inv(R), t


def _dlt_homography(src, dst) -> np.ndarray:
    """Least-squares homography (N>=4) with Hartley normalization."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)

    def norm_T(p):
        c = p.mean(axis=0)
        s = np.sqrt(2) / max(np.mean(np.linalg.norm(p - c, axis=1)), 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
        return T

    Ts, Td = norm_T(src), norm_T(dst)
    sp = (np.column_stack([src, np.ones(len(src))]) @ Ts.T)[:, :2]
    dp = (np.column_stack([dst, np.ones(len(dst))]) @ Td.T)[:, :2]
    A = []
    for (x, y), (u, v) in zip(sp, dp):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ H @ Ts
    return H / H[2, 2]


def refine_pose_lm(obj, img, K, dist, rvec0, tvec0, max_iter: int = 50) -> Tuple[np.ndarray, np.ndarray]:
    """Levenberg–Marquardt refinement of (rvec, tvec) minimizing reprojection error."""
    from scipy.optimize import least_squares

    obj = np.asarray(obj, dtype=np.float64).reshape(-1, 3)
    img = np.asarray(img, dtype=np.float64).reshape(-1, 2)

    def residuals(x):
        return (project_points(obj, x[:3], x[3:], K, dist) - img).ravel()

    x0 = np.concatenate([np.asarray(rvec0).ravel(), np.asarray(tvec0).ravel()])
    res = least_squares(residuals, x0, method="lm", max_nfev=max_iter * 8)
    return res.x[:3], res.x[3:]


def solve_pnp_iterative(obj, img, K, dist=None, rvec0=None, tvec0=None) -> Tuple[bool, np.ndarray, np.ndarray]:
    obj = np.asarray(obj, dtype=np.float64).reshape(-1, 3)
    img = np.asarray(img, dtype=np.float64).reshape(-1, 2)
    if rvec0 is None or tvec0 is None:
        rvec0, tvec0 = _pnp_init(obj, img, np.asarray(K, dtype=np.float64), dist)
    rv, tv = refine_pose_lm(obj, img, K, dist, rvec0, tvec0)
    return True, rv.reshape(3, 1), tv.reshape(3, 1)


# ----------------------------------------------------------------------------------
# 2-D affine fits (stabilization + nadir GCP expansion)
# ----------------------------------------------------------------------------------


def estimate_affine_partial_2d(src, dst) -> np.ndarray:
    """Least-squares similarity transform (rotation+scale+translation), (2,3) matrix."""
    src = np.asarray(src, dtype=np.float64).reshape(-1, 2)
    dst = np.asarray(dst, dtype=np.float64).reshape(-1, 2)
    cs, cd = src.mean(axis=0), dst.mean(axis=0)
    s0, d0 = src - cs, dst - cd
    # complex least squares: d = z * s
    a = np.sum(s0[:, 0] * d0[:, 0] + s0[:, 1] * d0[:, 1])
    b = np.sum(s0[:, 0] * d0[:, 1] - s0[:, 1] * d0[:, 0])
    denom = np.sum(s0**2)
    ca_, sa_ = a / denom, b / denom
    A = np.array([[ca_, -sa_], [sa_, ca_]])
    t = cd - A @ cs
    return np.column_stack([A, t])


def estimate_affine_2d(src, dst, ransac_thresh: float = 3.0, iters: int = 200, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Full 6-dof affine fit with simple RANSAC; returns (M (2,3), inlier mask)."""
    src = np.asarray(src, dtype=np.float64).reshape(-1, 2)
    dst = np.asarray(dst, dtype=np.float64).reshape(-1, 2)
    n = len(src)

    def fit(idx):
        A = np.column_stack([src[idx], np.ones(len(idx))])
        sol, *_ = np.linalg.lstsq(A, dst[idx], rcond=None)
        return sol.T  # (2,3)

    if n <= 3:
        M = fit(np.arange(n))
        return M, np.ones(n, dtype=bool)
    rng = np.random.default_rng(seed)
    best_inl = None
    for _ in range(iters):
        idx = rng.choice(n, 3, replace=False)
        try:
            M = fit(idx)
        except np.linalg.LinAlgError:
            continue
        pred = src @ M[:, :2].T + M[:, 2]
        err = np.linalg.norm(pred - dst, axis=1)
        inl = err < ransac_thresh
        if best_inl is None or inl.sum() > best_inl.sum():
            best_inl = inl
    if best_inl is None or best_inl.sum() < 3:
        best_inl = np.ones(n, dtype=bool)
    M = fit(np.where(best_inl)[0])
    return M, best_inl


# ----------------------------------------------------------------------------------
# Zhang calibration (chessboard)
# ----------------------------------------------------------------------------------


def calibrate_camera_zhang(
    obj_pts_list: List[np.ndarray],
    img_pts_list: List[np.ndarray],
    image_size: Tuple[int, int],
    fix_aspect: bool = True,
    n_dist: int = 5,
) -> Tuple[float, np.ndarray, np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """Zhang's method: per-view homographies -> closed-form intrinsics -> LM bundle.

    Replaces cv2.calibrateCamera (reference pyorc/cv.py:653). Returns
    (rms, camera_matrix, dist_coeffs (1,n_dist), rvecs, tvecs).
    """
    from scipy.optimize import least_squares

    w, h = image_size
    Hs = []
    for obj, img in zip(obj_pts_list, img_pts_list):
        obj2 = np.asarray(obj, dtype=np.float64).reshape(-1, 3)[:, :2]
        img2 = np.asarray(img, dtype=np.float64).reshape(-1, 2)
        Hs.append(_dlt_homography(obj2, img2))

    # closed-form intrinsics from homography constraints (Zhang 2000)
    def v_ij(H, i, j):
        return np.array(
            [
                H[0, i] * H[0, j],
                H[0, i] * H[1, j] + H[1, i] * H[0, j],
                H[1, i] * H[1, j],
                H[2, i] * H[0, j] + H[0, i] * H[2, j],
                H[2, i] * H[1, j] + H[1, i] * H[2, j],
                H[2, i] * H[2, j],
            ]
        )

    V = []
    for H in Hs:
        V.append(v_ij(H, 0, 1))
        V.append(v_ij(H, 0, 0) - v_ij(H, 1, 1))
    V = np.asarray(V)
    _, _, Vt = np.linalg.svd(V)
    b = Vt[-1]
    B11, B12, B22, B13, B23, B33 = b
    try:
        v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12**2)
        lam = B33 - (B13**2 + v0 * (B12 * B13 - B11 * B23)) / B11
        alpha = np.sqrt(lam / B11)
        beta = np.sqrt(lam * B11 / (B11 * B22 - B12**2))
        gamma = -B12 * alpha**2 * beta / lam
        u0 = gamma * v0 / beta - B13 * alpha**2 / lam
        if not (np.isfinite([alpha, beta, u0, v0]).all() and alpha > 0 and beta > 0):
            raise FloatingPointError
    except (FloatingPointError, ZeroDivisionError):
        alpha = beta = 1.2 * max(w, h)
        u0, v0 = w / 2, h / 2
    if fix_aspect:
        alpha = beta = (alpha + beta) / 2
    K0 = np.array([[alpha, 0, u0], [0, beta, v0], [0, 0, 1]])

    # per-view extrinsics init
    rvecs0, tvecs0 = [], []
    for H in Hs:
        A = np.linalg.inv(K0) @ H
        lam2 = 1.0 / np.linalg.norm(A[:, 0])
        r1 = A[:, 0] * lam2
        r2 = A[:, 1] * lam2
        r2 -= (r1 @ r2) * r1
        r2 /= np.linalg.norm(r2)
        r3 = np.cross(r1, r2)
        t = A[:, 2] * lam2
        if t[2] < 0:
            r1, r2, t = -r1, -r2, -t
            r3 = np.cross(r1, r2)
        R = np.stack([r1, r2, r3], axis=1)
        U, _, Vt2 = np.linalg.svd(R)
        rvecs0.append(rodrigues_inv(U @ Vt2))
        tvecs0.append(t)

    n_views = len(Hs)

    def unpack(x):
        fx, fy, cx, cy = x[0], (x[0] if fix_aspect else x[1]), x[2], x[3]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        dist = x[4 : 4 + n_dist]
        poses = x[4 + n_dist :].reshape(n_views, 6)
        return K, dist, poses

    def residuals(x):
        K, dist, poses = unpack(x)
        res = []
        for obj, img, pose in zip(obj_pts_list, img_pts_list, poses):
            proj = project_points(np.asarray(obj).reshape(-1, 3), pose[:3], pose[3:], K, dist)
            res.append((proj - np.asarray(img, dtype=np.float64).reshape(-1, 2)).ravel())
        return np.concatenate(res)

    x0 = np.concatenate(
        [
            [K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]],
            np.zeros(n_dist),
            np.concatenate([np.concatenate([rv, tv]) for rv, tv in zip(rvecs0, tvecs0)]),
        ]
    )
    sol = least_squares(residuals, x0, method="lm", max_nfev=400)
    K, dist, poses = unpack(sol.x)
    rms = float(np.sqrt(np.mean(sol.fun**2) * 2))  # per-point RMS distance
    rvecs = [p[:3] for p in poses]
    tvecs = [p[3:] for p in poses]
    return rms, K, dist.reshape(1, -1), rvecs, tvecs
