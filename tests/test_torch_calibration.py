"""The port's chessboard lens calibration against the JAX package's on the CPU.

A synthetic clip (640x480, 10 frames) shows a 10x7-square chessboard (9x6 inner
corners) under a pinhole camera (f = 600 px, principal point at the centre)
from ten poses, drawn with OpenCV's ``warpPerspective`` and written as a
lossless FFV1 clip. Both packages detect the corners with OpenCV and run the
same Zhang calibration, so the intrinsic matrix and the distortion must be
equal (to 1e-9), and close to the camera that drew the clip.
"""

import numpy as np
import pytest

import pyorc_tpu
import pyorc_tpu_torch
from pyorc_tpu.io import calibration as jcal
from pyorc_tpu_torch.io import calibration as tcal

import chip_smoke

H, W = 480, 640
F = 600.0
SQUARE = 40  # px per square of the board image


def _view(board, rvec, tvec, cv2):
    """The board (z = 0 plane, one unit per square) seen by the pinhole camera at pose (rvec, tvec)."""
    rot, _ = cv2.Rodrigues(np.asarray(rvec, np.float64))
    k = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])
    board_to_image = k @ np.column_stack([rot[:, 0], rot[:, 1], np.asarray(tvec, np.float64)])
    pixels_to_board = np.diag([1.0 / SQUARE, 1.0 / SQUARE, 1.0])
    return cv2.warpPerspective(board, board_to_image @ pixels_to_board, (W, H), borderValue=255)


@pytest.fixture(scope="module")
def chessboard_clip(tmp_path_factory):
    import cv2

    squares = (np.add.outer(np.arange(7), np.arange(10)) % 2).astype(np.uint8) * 255
    board = np.kron(squares, np.ones((SQUARE, SQUARE), np.uint8))
    board = np.pad(board, SQUARE, constant_values=255)[SQUARE:, SQUARE:]  # a white margin right and below
    rng = np.random.default_rng(5)
    frames = []
    for i in range(10):
        rvec = rng.uniform(-0.35, 0.35, 3)
        tvec = [-4.5 + rng.uniform(-1, 1), -3.0 + rng.uniform(-1, 1), 14.0 + rng.uniform(-2, 2)]
        frames.append(_view(board, rvec, tvec, cv2))
    path = tmp_path_factory.mktemp("calib") / "chessboard.avi"
    return str(chip_smoke.write_clip(np.stack(frames), path, fps=5.0))


def test_calibrate_camera_equals_jax(chessboard_clip):
    got = tcal.calibrate_camera(chessboard_clip, progress_bar=False)
    want = jcal.calibrate_camera(chessboard_clip, progress_bar=False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
    k = np.asarray(got[0])
    assert abs(k[0, 0] - F) < 0.02 * F and abs(k[1, 1] - F) < 0.02 * F
    assert abs(k[0, 2] - W / 2) < 10 and abs(k[1, 2] - H / 2) < 10


def test_camera_config_calibration_video_equals_jax(chessboard_clip):
    """``CameraConfig(calibration_video=...)`` sets JAX's intrinsics, and a tolerance drops
    no frame of a clean clip."""
    pyorc_tpu_torch.set_device("cpu")
    got = pyorc_tpu_torch.CameraConfig(height=H, width=W, calibration_video=chessboard_clip)
    want = pyorc_tpu.CameraConfig(height=H, width=W, calibration_video=chessboard_clip)
    np.testing.assert_allclose(got.camera_matrix, want.camera_matrix, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.dist_coeffs, want.dist_coeffs, rtol=1e-9, atol=1e-9)
    tol = tcal.calibrate_camera(chessboard_clip, progress_bar=False, tolerance=5.0)
    np.testing.assert_allclose(tol[0], got.camera_matrix, rtol=1e-9)


def test_calibration_errors(chessboard_clip, tmp_path):
    with pytest.raises(FileNotFoundError, match="not found"):
        pyorc_tpu_torch.CameraConfig(height=H, width=W, calibration_video=str(tmp_path / "missing.avi"))
    blank = chip_smoke.write_clip(np.full((6, H, W), 128, np.uint8), tmp_path / "blank.avi", fps=5.0)
    with pytest.raises(ValueError, match="minimum of 5 frames"):
        tcal.calibrate_camera(str(blank), progress_bar=False)
    assert tcal.staggered_index(0, 9) == jcal.staggered_index(0, 9)
