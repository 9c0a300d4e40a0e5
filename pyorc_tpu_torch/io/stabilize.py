"""Video stabilization: feature tracking -> per-frame affine -> temporal smoothing.

Port of :mod:`pyorc_tpu.io.stabilize` (cv2 and tqdm imported inside the functions).

Mirrors reference ``pyorc/cv.py:289-369,476-502,64-89``: Good-Features-to-Track
per image quadrant + pyramidal Lucas-Kanade flow (host OpenCV, the decode-side
C++ path), affine estimation via our own least-squares/RANSAC fit
(:func:`pyorc_tpu_torch.geom.camera.estimate_affine_2d`), key-frame refresh every 30
frames, and a temporal box filter over the affine series.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np

from ..geom.camera import estimate_affine_2d

__all__ = ["get_ms_gftt"]


def _gftt_split(img, split: int, n_pts: int, mask=None) -> np.ndarray:
    """Good features to track per image quadrant. Reference pyorc/cv.py:476-502."""
    import cv2

    v = 0
    h = 0
    ver_split, hor_split = np.int16(np.ceil(np.array(img.shape) / split))
    pts = np.zeros((0, 1, 2), np.float32)
    while v < img.shape[0]:
        while h < img.shape[1]:
            sub_img = img[v : v + ver_split, h : h + hor_split]
            subimg_pts = cv2.goodFeaturesToTrack(
                sub_img,
                mask=mask[v : v + ver_split, h : h + hor_split] if mask is not None else None,
                maxCorners=int(n_pts / split**2),
                qualityLevel=0.3,
                minDistance=10,
                blockSize=1,
            )
            if subimg_pts is not None:
                subimg_pts[:, :, 0] += h
                subimg_pts[:, :, 1] += v
                pts = np.append(pts, subimg_pts, axis=0)
            h += hor_split
        h = 0
        v += ver_split
    return pts


def _combine_m(m_key: np.ndarray, m_part: np.ndarray) -> np.ndarray:
    """Compose a key-frame affine with an incremental affine. Reference pyorc/cv.py:64-89."""
    m_key3 = np.vstack([m_key, [0, 0, 1]])
    m_part3 = np.vstack([m_part, [0, 0, 1]])
    return (m_part3 @ m_key3)[:2]


def get_ms_gftt(
    cap,
    start_frame: int = 0,
    end_frame: Optional[int] = None,
    n_pts: Optional[int] = None,
    split: int = 2,
    mask=None,
    wdw: int = 4,
    progress: bool = True,
) -> List[np.ndarray]:
    """Per-frame smoothed affine transforms stabilizing the video."""
    import cv2
    from tqdm import tqdm

    end_frame = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) if end_frame is None else end_frame
    m = np.eye(3)[0:2]
    ms = []
    m_key = copy.deepcopy(m)
    cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)
    n_frames = int(end_frame + 1) - int(start_frame)

    _, img_key = cap.read()
    img1 = cv2.cvtColor(img_key, cv2.COLOR_BGR2GRAY)
    img_key = img1
    if n_pts is None:
        n_pts = int(np.sqrt(img_key.size))
    prev_pts = _gftt_split(img_key, split, n_pts, mask=mask)
    if prev_pts is None or len(prev_pts) < 3:
        raise ValueError(
            "No trackable features found outside the stabilization polygon. The polygon should "
            "enclose only the water surface, leaving stable bank area visible for tracking."
        )

    pbar = tqdm(range(n_frames - 1), position=0, leave=True, disable=not progress)
    pbar.set_description("Deriving stabilization parameters")
    for i in pbar:
        ms.append(m)
        ret, img2 = cap.read()
        if not ret:
            break
        img2 = cv2.cvtColor(img2, cv2.COLOR_BGR2GRAY)
        curr_pts, status, err = cv2.calcOpticalFlowPyrLK(img_key, img2, prev_pts, None)
        ok = status.ravel() == 1
        m_part, _ = estimate_affine_2d(curr_pts[ok, 0], prev_pts[ok, 0])
        m = _combine_m(m_key, m_part)
        if i % 30 == 0:
            img_key = img1
            prev_pts = _gftt_split(img_key, split, n_pts, mask=mask)
            m_key = copy.deepcopy(m)
        img1 = img2
    ms.append(m)
    # temporal box filter over the affine series (window clamped for short videos)
    ma = np.array(ms)
    wdw = min(wdw, (len(ms) - 1) // 2)
    if wdw > 0:
        for r in range(ma.shape[1]):
            for c in range(ma.shape[2]):
                ma[wdw:-wdw, r, c] = np.convolve(
                    ma[:, r, c], np.ones(wdw * 2 + 1) / (wdw * 2 + 1), mode="valid"
                )
    return list(ma)
