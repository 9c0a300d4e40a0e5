"""The port's frame normalization, ortho index maps, projection and polygon
fill against the JAX package (and OpenCV for the fill) on the CPU."""

import cv2
import numpy as np
import pytest
import torch

import pyorc_tpu
from pyorc_tpu.ops import filters as jflt
from pyorc_tpu.ops import ortho as jortho

import pyorc_tpu_torch
from pyorc_tpu_torch.geom import shapes as tshapes
from pyorc_tpu_torch.ops import filters as tflt
from pyorc_tpu_torch.ops import ortho as tortho

H, W = 240, 320

# (resolution, AOI corners in camera pixels): finer cells than pixels (no
# mean groups), coarser cells (mean groups) with the AOI ring crossing the
# frame border, and coarser cells inside the frame
AOIS = [
    (0.02, [[60, 200], [260, 200], [225, 70], [95, 70]]),
    (0.05, [[20, 230], [300, 230], [250, 30], [70, 30]]),
    (0.04, [[50, 215], [270, 215], [230, 55], [90, 55]]),
]


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


def oblique_camera_config(res, corners):
    """Oblique camera with radial distortion (JAX package's CameraConfig)."""
    cc = pyorc_tpu.CameraConfig(
        height=H,
        width=W,
        resolution=res,
        window_size=16,
        gcps={
            "src": [[40, 210], [280, 210], [235, 50], [85, 50]],
            "dst": [[0, 0], [6, 0], [6, 8], [0, 8]],
            "h_ref": 0.0,
            "z_0": 0.0,
        },
        camera_matrix=[[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1]],
        dist_coeffs=[[-0.05], [0.0], [0.0], [0.0], [0.0]],
        stabilize=None,
    )
    cc.set_bbox_from_corners(corners)
    return cc


def _grid(cc):
    shape = cc.shape
    y = np.flipud(np.linspace(cc.resolution / 2, cc.resolution * (shape[0] - 0.5), shape[0]))
    x = np.linspace(cc.resolution / 2, cc.resolution * (shape[1] - 0.5), shape[1])
    return x, y


def _both_maps(cc_jax):
    """OrthoMaps from each package, the port's built from the JSON."""
    cc_torch = pyorc_tpu_torch.get_camera_config(cc_jax.to_json())
    x, y = _grid(cc_jax)
    z = cc_jax.get_z_a(0.0)
    return jortho.build_ortho_maps(cc_jax, x, y, z), tortho.build_ortho_maps(cc_torch, x, y, z)


def test_normalize_bytes_equal(rng):
    frames = rng.integers(0, 256, size=(6, 60, 80), dtype=np.uint8)
    mean = frames[::2].astype(np.float32).mean(axis=0).astype(np.float32)
    want = np.asarray(jflt.normalize_with_mean(frames, mean))
    got = tflt.normalize_with_mean(torch.as_tensor(frames), torch.as_tensor(mean)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    red = frames.astype(np.float32) - mean
    fmin = red.min(axis=(-2, -1), keepdims=True)
    fmax = red.max(axis=(-2, -1), keepdims=True)
    want = np.asarray(jflt.normalize_with_stats(frames, mean, fmin, fmax))
    got = tflt.normalize_with_stats(*(torch.as_tensor(a) for a in (frames, mean, fmin, fmax))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("res,corners", AOIS, ids=["fine", "coarse-crossing", "coarse"])
def test_ortho_maps_equal(res, corners):
    mj, mt = _both_maps(oblique_camera_config(res, corners))
    assert type(mt).__name__ == "OrthoMaps" and mt._fields == mj._fields
    for name in mj._fields:
        a, b = getattr(mj, name), getattr(mt, name)
        if a is None or b is None:
            assert a is None and b is None, name
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=name)
    if res >= 0.04:
        assert mt.src_idx is not None  # the group-mean path is exercised


@pytest.mark.parametrize("res,corners", AOIS, ids=["fine", "coarse-crossing", "coarse"])
def test_project_batch_equal(rng, res, corners):
    mj, mt = _both_maps(oblique_camera_config(res, corners))
    frames = rng.integers(0, 256, size=(3, H, W), dtype=np.uint8)
    want = np.asarray(jortho.project_batch(frames, mj))
    got = tortho.project_batch(torch.as_tensor(frames), mt).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    f32 = frames.astype(np.float32) / 7.0
    want = np.asarray(jortho.project_batch(f32, mj))
    got = tortho.project_batch(torch.as_tensor(f32), mt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_project_batch_separable_paths(rng):
    """Nadir maps take the separable paths: strided slices, and the row/column take."""
    cc = pyorc_tpu.CameraConfig(
        height=H, width=W, resolution=0.01, window_size=16,
        gcps={"src": [[60, 60], [260, 60], [260, 180], [60, 180]],
              "dst": [[0.6, 1.8], [2.6, 1.8], [2.6, 0.6], [0.6, 0.6]], "h_ref": 0.0, "z_0": 0.0},
        camera_matrix=[[1000.0, 0, W / 2], [0, 1000.0, H / 2], [0, 0, 1]],
        dist_coeffs=[[0.0]] * 5, stabilize=None,
    )
    cc.set_bbox_from_corners([[100, 100], [220, 100], [220, 160], [100, 160]])
    mj, mt = _both_maps(cc)
    frames = rng.integers(0, 256, size=(2, H, W), dtype=np.uint8)
    for maps_j, maps_t in ((mj, mt), (mj._replace(row_idx=mj.row_idx[::-1].copy()),
                                      mt._replace(row_idx=mt.row_idx[::-1].copy()))):
        if maps_j.row_idx is None:
            pytest.fail("nadir maps should be separable")
        want = np.asarray(jortho.project_batch(frames, maps_j))
        got = tortho.project_batch(torch.as_tensor(frames), maps_t).numpy()
        np.testing.assert_array_equal(got, want)


def test_fill_polygon_matches_cv2(rng):
    """The numpy scan-line fill gives cv2.fillPoly's pixels: camera-frame
    AOI rings of the configs above (hundreds of vertices, some outside the
    frame) and random polygons, convex or not, inside and across the border."""
    rings = []
    for res, corners in AOIS:
        cc = oblique_camera_config(res, corners)
        ring = np.asarray(cc.get_bbox(mode="camera", z_a=0.0).exterior.coords, dtype=np.float64)
        rings.append(((H, W), np.round(ring[np.isfinite(ring).all(axis=1)]).astype(np.int32)))
    for k in range(120):
        h, w = (int(v) for v in rng.integers(16, 90, 2))
        n = int(rng.integers(3, 9))
        pad = 0 if k % 2 else 25
        pts = np.stack([rng.integers(-pad, w + pad, n), rng.integers(-pad, h + pad, n)], 1)
        rings.append(((h, w), pts.astype(np.int32)))
    for shape, ring in rings:
        want = np.zeros(shape, np.uint8)
        cv2.fillPoly(want, [ring], 1)
        np.testing.assert_array_equal(tshapes.fill_polygon(shape, ring), want == 1)
