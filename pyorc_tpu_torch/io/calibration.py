"""Chessboard lens calibration from a video file.

A copy of :mod:`pyorc_tpu.io.calibration`, which mirrors reference
``pyorc/cv.py:574-672`` (calibrate_camera): staggered frame
sampling, chessboard corner detection (host OpenCV, like video decode), then
our own Zhang calibration (:func:`pyorc_tpu_torch.geom.camera.calibrate_camera_zhang`)
with reprojection-error-based frame rejection.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..geom import camera as cam

__all__ = ["calibrate_camera", "staggered_index"]


def staggered_index(start: int = 0, end: int = 100) -> list:
    """Frame index order that spreads samples across the video: recursively bisected.

    Mirrors reference ``pyorc/helpers.py:682-713``.
    """
    idx = [start, end]
    level = [(start, end)]
    while level:
        nxt = []
        for a, b in level:
            m = (a + b) // 2
            if m != a and m != b:
                idx.append(m)
                nxt.append((a, m))
                nxt.append((m, b))
        level = nxt
    # dedupe preserving order
    seen = set()
    out = []
    for i in idx:
        if i not in seen:
            seen.add(i)
            out.append(int(i))
    return out


def calibrate_camera(
    fn: str,
    chessboard_size: Tuple[int, int] = (9, 6),
    max_imgs: int = 30,
    plot: bool = False,
    progress_bar: bool = True,
    to_file: bool = False,
    frame_limit: Optional[int] = None,
    tolerance: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Intrinsic matrix + distortion coefficients from a chessboard video."""
    import cv2
    from tqdm import tqdm

    cap = cv2.VideoCapture(fn)
    frames_count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    frames_list = staggered_index(start=0, end=frames_count - 1)

    objp = np.zeros((chessboard_size[0] * chessboard_size[1], 3), np.float32)
    objp[:, :2] = np.mgrid[0 : chessboard_size[0], 0 : chessboard_size[1]].T.reshape(-1, 2)

    obj_pts, img_pts = [], []
    ret_img, img = cap.read()
    frame_size = img.shape[1], img.shape[0]
    if frame_limit is not None:
        frames_list = frames_list[0:frame_limit]
    it = tqdm(frames_list, position=0, leave=True) if progress_bar else frames_list
    criteria = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 0.001)
    for f in it:
        cap.set(cv2.CAP_PROP_POS_FRAMES, f)
        ret_img, img = cap.read()
        if not ret_img:
            continue
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        ret, corners = cv2.findChessboardCorners(gray, chessboard_size, flags=cv2.CALIB_CB_FAST_CHECK)
        if ret:
            corners2 = cv2.cornerSubPix(gray, corners, (11, 11), (-1, -1), criteria)
            obj_pts.append(objp.copy())
            # OpenCV returns (N, 1, 2) or (N, 2) depending on build; normalize
            img_pts.append(np.asarray(corners2, dtype=np.float64).reshape(-1, 2))
            if len(obj_pts) == max_imgs:
                break
    cap.release()
    if len(obj_pts) < 5:
        raise ValueError(
            f"A minimum of 5 frames with chessboard patterns must be available, only {len(obj_pts)} found. "
            f"Check if the video contains chessboard patterns of size {chessboard_size}."
        )
    rms, K, dist, rvecs, tvecs = cam.calibrate_camera_zhang(obj_pts, img_pts, frame_size)
    if tolerance is not None:
        # reject frames with high reprojection error, then recalibrate
        keep_obj, keep_img = [], []
        for obj, img2, rv, tv in zip(obj_pts, img_pts, rvecs, tvecs):
            proj = cam.project_points(obj, rv, tv, K, dist)
            err = float(np.sqrt(np.mean(np.sum((proj - img2) ** 2, axis=1))))
            if err <= tolerance:
                keep_obj.append(obj)
                keep_img.append(img2)
        if len(keep_obj) >= 5 and len(keep_obj) < len(obj_pts):
            rms, K, dist, rvecs, tvecs = cam.calibrate_camera_zhang(keep_obj, keep_img, frame_size)
    return K, dist
