"""The ortho index maps built as tensor ops (``build_ortho_maps_tensor``, what a
card runs) against the JAX package's host maps and the port's host path, element
for element, on CPU tensors; each tensor twin in ``geom/camera.py`` and
``geom/affine.py`` against its host function on 10^5 seeded points; and no host
fallback where CUDA is selected but absent."""

import warnings
from fractions import Fraction

import numpy as np
import pytest
import torch

import chip_smoke
import pyorc_tpu
from pyorc_tpu.ops import ortho as jortho

import pyorc_tpu_torch
from pyorc_tpu_torch.geom import affine as aff
from pyorc_tpu_torch.geom import camera as cam
from pyorc_tpu_torch.ops import ortho as tortho
from test_torch_ortho_filters import AOIS, _grid, oblique_camera_config

N_POINTS = 100_000
# k1 k2 p1 p2 k3 k4 k5 k6, all nonzero
DIST = np.array([-0.31, 0.12, 0.0021, -0.0013, -0.052, 0.011, -0.021, 0.0032])
K = np.array([[1200.0, 0.0, 955.3], [0.0, 1190.0, 541.7], [0.0, 0.0, 1.0]])


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


def _cameras():
    """(id, port CameraConfig, grid x, grid y, z) of every camera the maps are held on."""
    out = []
    for (res, corners), name in zip(AOIS, ("fine", "coarse-crossing", "coarse")):
        cc = pyorc_tpu_torch.get_camera_config(oblique_camera_config(res, corners).to_json())
        out.append((f"oblique-{name}", cc, 0.0))
    out.append(("geul", chip_smoke.geul_camera_config(), None))
    out.append(("nadir-270x480", chip_smoke.nadir_camera_config(270, 480), 0.0))
    return out


def _assert_maps_equal(got, want, label):
    assert got._fields == want._fields
    for name in want._fields:
        a, b = getattr(want, name), getattr(got, name)
        if a is None or b is None:
            assert a is None and b is None, (label, name)
        elif isinstance(a, np.ndarray):
            assert b.dtype == a.dtype, (label, name)
            np.testing.assert_array_equal(b, a, err_msg=f"{label}: {name}")
        else:
            assert b == a, (label, name)


@pytest.mark.parametrize("label,cc,h_a", _cameras(), ids=[c[0] for c in _cameras()])
def test_tensor_maps_equal_host_maps(label, cc, h_a):
    cc_jax = pyorc_tpu.get_camera_config(cc.to_json())
    x, y = _grid(cc)
    z = cc.get_z_a(h_a)
    got = tortho.build_ortho_maps_tensor(cc, x, y, z, device="cpu")
    _assert_maps_equal(got, jortho.build_ortho_maps(cc_jax, x, y, z), f"{label} vs JAX")
    _assert_maps_equal(got, tortho.build_ortho_maps(cc, x, y, z), f"{label} vs the port's host path")
    assert (got.full_idx < cc.height * cc.width).any()
    if label in ("oblique-coarse", "geul"):
        assert got.src_idx is not None  # the group mean is exercised
    if label.startswith("nadir"):
        assert got.row_idx is not None  # the separable path is taken


@pytest.mark.parametrize("reducer", ["nearest", "mean"])
def test_tensor_maps_no_cover_warns_as_host(reducer):
    """A water level that leaves no cell covered warns as the host does, and gives the same maps."""
    cc = pyorc_tpu_torch.get_camera_config(oblique_camera_config(*AOIS[2]).to_json())
    x, y = _grid(cc)
    z = cc.get_z_a(0.0) + 1e4
    with pytest.warns(UserWarning, match="No pixels in the objective"):
        got = tortho.build_ortho_maps_tensor(cc, x, y, z, reducer=reducer, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = tortho.build_ortho_maps(cc, x, y, z, reducer=reducer)
    _assert_maps_equal(got, want, "no cover")


def test_build_ortho_maps_on_cuda_raises_without_cuda(monkeypatch):
    """Where CUDA is selected and absent the maps raise; the host path is not run."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    cc = chip_smoke.nadir_camera_config(270, 480)
    x, y = _grid(cc)

    def host(*args, **kwargs):
        raise AssertionError("fell back to the host maps")

    monkeypatch.setattr(cc, "map_idx_img_ortho", host)
    monkeypatch.setattr(cc, "map_mean_idx_img_ortho", host)
    with pytest.raises(RuntimeError, match="cuda"):
        tortho.build_ortho_maps(cc, x, y, 0.0, device="cuda")
    pyorc_tpu_torch.set_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            tortho.build_ortho_maps(cc, x, y, 0.0)
    finally:
        pyorc_tpu_torch.set_device("cpu")


# -- the tensor twins ------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pose(name):
    cc = chip_smoke.geul_camera_config() if name == "geul" else chip_smoke.nadir_camera_config(1080, 1920)
    return cc, np.array(cc.rvec, dtype=np.float64), np.array(cc.tvec, dtype=np.float64)


def _world_points(rng, cc):
    pts = np.column_stack([rng.uniform(-5, 25, N_POINTS), rng.uniform(-5, 15, N_POINTS), rng.uniform(-2, 2, N_POINTS)])
    dst = np.asarray(cc.gcps["dst"], dtype=np.float64)
    pts[:, :2] += dst[0, :2]
    pts[:, 2] += cc.gcps["z_0"]
    return pts


def test_distort_normalized_tensor_bitwise(rng):
    pts = rng.uniform(-0.7, 0.7, (N_POINTS, 2))
    np.testing.assert_array_equal(cam.distort_normalized_tensor(_t(pts), DIST).numpy(), cam.distort_normalized(pts, DIST))


def test_undistort_normalized_tensor_bitwise(rng):
    pts = rng.uniform(-0.7, 0.7, (N_POINTS, 2))
    for iterations in (5, 2):
        got = cam.undistort_normalized_tensor(_t(pts), DIST, iterations).numpy()
        np.testing.assert_array_equal(got, cam.undistort_normalized(pts, DIST, iterations))


@pytest.mark.parametrize("P", ["same", None, "other"])
def test_undistort_points_tensor_bitwise(rng, P):
    pts = rng.uniform(0, 1920, (N_POINTS, 2))
    P = np.array([[1000.0, 0, 900.5], [0, 1010.0, 500.25], [0, 0, 1]]) if P == "other" else P
    got = cam.undistort_points_tensor(_t(pts), K, DIST, P).numpy()
    np.testing.assert_array_equal(got, cam.undistort_points(pts, K, DIST, P))


def test_fma_emulation_is_exact(rng):
    """``_fma`` rounds ``a * b + c`` once, as exact rational arithmetic rounded to float64 does: random
    magnitudes, sums that cancel to a few ulps or sit half an ulp off the product, and sums a hair
    below a tie (a * b = 1 - 2^-54 scaled, c odd in its last bit), where rounding twice goes wrong."""
    m = 1500
    a = rng.uniform(1, 2, m) * 2.0 ** rng.integers(-40, 40, m) * rng.choice([-1, 1], m)
    b = rng.uniform(1, 2, m) * 2.0 ** rng.integers(-40, 40, m) * rng.choice([-1, 1], m)
    p = a * b
    scale = 2.0 ** rng.integers(-30, 30, m)
    sign = rng.choice([-1.0, 1.0], m)
    cases = [
        (a, b, rng.standard_normal(m) * np.abs(p) * 2.0 ** rng.integers(-60, 60, m)),
        (a, b, -p + np.spacing(p) * rng.integers(-4, 5, m) / 2),
        (a, b, np.spacing(p) * 0.5 * rng.choice([-1, 1], m)),
        ((1 + 2.0 ** -27) * scale * sign, (1 - 2.0 ** -27) * scale,
         (2.0 ** 53 + 2.0 * (2 * rng.integers(0, 2 ** 20, m) + 1)) * scale * scale * sign),
    ]
    for x, y, c in cases:
        want = [float(Fraction(u) * Fraction(v) + Fraction(w)) for u, v, w in zip(x, y, c)]
        np.testing.assert_array_equal(cam._fma(_t(x), _t(y), _t(c)).numpy(), want)


def _plain_points_times(pts, m):
    """``pts @ m.T`` as a BLAS without fused multiply-adds rounds it: each product and sum, k = 0, 1, 2."""
    return (pts[:, :1] * m[:, 0] + pts[:, 1:2] * m[:, 1]) + pts[:, 2:3] * m[:, 2]


def _fused_points_times(pts, m):
    """``pts @ m.T`` as an FMA-chaining BLAS rounds it, through the exact emulated FMA."""
    p, q = _t(pts), _t(m)
    return cam._fma(p[:, 2:3], q[:, 2], cam._fma(p[:, 1:2], q[:, 1], p[:, :1] * q[:, 0])).numpy()


@pytest.mark.parametrize("rule", ["fma", "plain"])
def test_twins_follow_the_hosts_blas_rule(rng, monkeypatch, caplog, rule):
    """With the host's 3x3 products made to round one way, the first-use probe finds that way and logs
    it, and the twins then give that host's points and ortho maps bit for bit; the other rule's twins
    would not give its points."""
    import logging

    monkeypatch.setattr(cam, "_points_times", {"fma": _fused_points_times, "plain": _plain_points_times}[rule])
    monkeypatch.setattr(cam, "_BLAS_RULE", None)
    with caplog.at_level(logging.INFO, logger=cam.__name__):
        assert cam.host_blas_rule() == rule
    assert f"round as {rule}" in caplog.text
    cc, rvec, tvec = _pose("geul")
    pts = _world_points(rng, cc)
    want = cam.project_points(pts, rvec, tvec, K, DIST)
    np.testing.assert_array_equal(cam.project_points_tensor(_t(pts), rvec, tvec, K, DIST).numpy(), want)
    M = cam.homography_from_pose(rvec, tvec, K, z=cc.gcps["z_0"] + 0.3)
    uv = rng.uniform(0, 1920, (N_POINTS, 2))
    np.testing.assert_array_equal(cam.perspective_transform_tensor(_t(uv), M).numpy(), cam.perspective_transform(uv, M))
    for label, cc, h_a in [c for c in _cameras() if c[0] in ("geul", "oblique-coarse")]:
        x, y = _grid(cc)
        z = cc.get_z_a(h_a)
        got = tortho.build_ortho_maps_tensor(cc, x, y, z, device="cpu")
        _assert_maps_equal(got, tortho.build_ortho_maps(cc, x, y, z), f"{label}, {rule}")
    monkeypatch.setattr(cam, "_BLAS_RULE", {"fma": "plain", "plain": "fma"}[rule])
    assert (cam.project_points_tensor(_t(pts), rvec, tvec, K, DIST).numpy() != want).any()


def test_blas_probe_warns_on_another_rounding(monkeypatch, caplog):
    """A host whose products are neither rounding is logged as a warning; the twins keep the chain."""
    import logging

    monkeypatch.setattr(cam, "_points_times", lambda pts, m: np.full((len(pts), 3), 2.0**-53))
    monkeypatch.setattr(cam, "_BLAS_RULE", None)
    with caplog.at_level(logging.INFO, logger=cam.__name__):
        assert cam.host_blas_rule() == "fma"
    assert "neither an FMA chain nor plain products" in caplog.text


@pytest.mark.parametrize("pose", ["nadir", "geul"])
def test_project_points_tensor_bitwise(rng, pose):
    """Bitwise on both poses: Geul's world coordinates (~3e5 m) make every last bit of the 3x3 product count."""
    cc, rvec, tvec = _pose(pose)
    pts = _world_points(rng, cc)
    got = cam.project_points_tensor(_t(pts), rvec, tvec, K, DIST).numpy()
    np.testing.assert_array_equal(got, cam.project_points(pts, rvec, tvec, K, DIST))


@pytest.mark.parametrize("pose", ["nadir", "geul"])
def test_perspective_transform_tensor_bitwise(rng, pose):
    cc, rvec, tvec = _pose(pose)
    M = cam.homography_from_pose(rvec, tvec, K, z=cc.gcps["z_0"] + 0.3)
    pts = rng.uniform(0, 1920, (N_POINTS, 2))
    np.testing.assert_array_equal(cam.perspective_transform_tensor(_t(pts), M).numpy(), cam.perspective_transform(pts, M))


@pytest.mark.parametrize("pose", ["nadir", "geul"])
def test_unproject_to_plane_tensor_bitwise(rng, pose):
    cc, rvec, tvec = _pose(pose)
    z = cc.gcps["z_0"] + 0.3
    pts = rng.uniform(0, 1920, (N_POINTS, 2))
    got = cam.unproject_to_plane_tensor(_t(pts), z, rvec, tvec, K, DIST).numpy()
    np.testing.assert_array_equal(got, cam.unproject_to_plane(pts, z, rvec, tvec, K, DIST))


def test_pixel_to_map_tensor_bitwise(rng):
    transform = aff.Affine(0.01, 0.0021, 192100.5, 0.0021, -0.01, 313170.25)
    cols = rng.integers(0, 4000, N_POINTS)
    rows = rng.integers(0, 2500, N_POINTS)
    for got, want in zip(aff.pixel_to_map_tensor(_t(cols), _t(rows), transform), aff.pixel_to_map(cols, rows, transform)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_map_to_pixel_tensor_bitwise(rng):
    """Rounded half to even as the host rounds; NaN where the host's int64 cast gives its minimum."""
    transform = aff.Affine(0.01, 0.0021, 192100.5, 0.0021, -0.01, 313170.25)
    xs = rng.uniform(192090.0, 192140.0, N_POINTS)
    ys = rng.uniform(313140.0, 313175.0, N_POINTS)
    xs[:7] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the host's cast of NaN
        want = aff.map_to_pixel(xs, ys, transform)
    for got, w in zip(aff.map_to_pixel_tensor(_t(xs), _t(ys), transform), want):
        got = got.numpy()
        assert np.isnan(got[:7]).all() and (w[:7] == np.iinfo(np.int64).min).all()
        np.testing.assert_array_equal(got[7:], w[7:].astype(np.float64))
