"""The port's frame filters (``ops/filters.py``) and their ``Frames`` methods,
RGB frames included, against the JAX package on the CPU."""

import numpy as np
import pytest
import torch

import pyorc_tpu
from pyorc_tpu.ops import filters as jflt

import pyorc_tpu_torch
from pyorc_tpu_torch.ops import filters as tflt

import chip_smoke

T, H, W = 9, 60, 84
H_IMG, W_IMG = 240, 320  # camera frames of the accessor tests


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


def _frames(dtype, seed=0, shape=(T, H, W)):
    """A 0-255 stack: smooth structure plus noise, so blurs and differences have signal."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    f = gaussian_filter(rng.normal(size=shape), (0, 2, 2) + (0,) * (len(shape) - 3)) * 400 + 128
    f = np.clip(f + rng.normal(size=shape) * 8, 0, 255)
    return f.astype(np.uint8) if dtype == "uint8" else f.astype(np.float32)


@pytest.mark.parametrize("ksize", [1, 3, 5, 7, 9, 11, 15])
def test_gaussian_kernel_cv_equal(ksize):
    got, want = tflt.gaussian_kernel_cv(ksize), jflt.gaussian_kernel_cv(ksize)
    assert got.dtype == np.float32 and float(got.sum()) == 1.0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("ksize", [1, 3, 5, 7, 11])
def test_gaussian_blur(dtype, ksize):
    """Within 1e-3 on a 0-255 image (float32 sums of up to 11 taps in either order; TF32 would miss by ~0.1)."""
    frames = _frames(dtype)
    want = np.asarray(jflt.gaussian_blur(frames, ksize))
    got = tflt.gaussian_blur(torch.as_tensor(frames), ksize)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_gaussian_blur_is_cv2_reflect_101():
    """The border is OpenCV's default (REFLECT_101) and the kernel OpenCV's: cv2.GaussianBlur
    within 1e-3 at the sizes whose kernel OpenCV fixes for float images too (up to 7)."""
    import cv2

    frames = _frames("float32", seed=3)
    for ksize in (3, 5, 7):
        got = tflt.gaussian_blur(torch.as_tensor(frames), ksize).numpy()
        want = np.stack([cv2.GaussianBlur(f, (ksize, ksize), 0) for f in frames])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("ksizes", [(3, 5), (3, 7), (5, 11)])
def test_edge_detect(dtype, ksizes):
    """Difference of two blurs: within 1e-3 on a 0-255 image."""
    frames = _frames(dtype, seed=1)
    want = np.asarray(jflt.edge_detect(frames, *ksizes))
    got = tflt.edge_detect(torch.as_tensor(frames), *ksizes).numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("thres,absolute", [(0.0, False), (4.0, False), (-6.0, True), (2.5, True)])
def test_time_diff_exact(dtype, thres, absolute):
    """Exact: a float32 subtraction and a comparison. A negative threshold keeps negative
    differences, which ``abs`` then folds: the threshold comes first."""
    frames = _frames(dtype, seed=2)
    want = np.asarray(jflt.time_diff(frames, thres, absolute))
    got = tflt.time_diff(torch.as_tensor(frames), thres, absolute).numpy()
    assert got.dtype == np.float32 and got.shape == (T - 1, H, W)
    np.testing.assert_array_equal(got, want)
    if thres < 0:
        assert (np.diff(frames.astype(np.float32), axis=0) < 0).any() and (got >= 0).all()


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("bounds", [(-np.inf, np.inf), (40.0, 180.5), (-np.inf, 99.0), (100.0, np.inf)])
def test_minmax_exact(dtype, bounds):
    """Exact, float32 out for either input; NaN stays NaN."""
    frames = _frames(dtype, seed=4)
    if dtype == "float32":
        frames[0, 3, 5] = np.nan
    want = np.asarray(jflt.minmax(frames, *bounds))
    got = tflt.minmax(torch.as_tensor(frames), *bounds).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_frame_range_exact(dtype):
    frames = _frames(dtype, seed=5)
    want = np.asarray(jflt.frame_range(frames))
    got = tflt.frame_range(torch.as_tensor(frames)).numpy()
    assert got.dtype == want.dtype == frames.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("samples", [2, 4, 9])
def test_reduce_rolling_uint8_bytes_equal(samples):
    """uint8 frames: every partial sum is an integer below 2**24, so the bytes are JAX's."""
    frames = _frames("uint8", seed=6)
    frames[:, 10:14, 20:30] = 0  # pixels whose rolling mean is 0 stay 0
    want = np.asarray(jflt.reduce_rolling(frames, samples))
    got = tflt.reduce_rolling(torch.as_tensor(frames), samples).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert not got[: samples - 1].any() and not got[:, 10:14, 20:30].any()
    assert got[samples - 1 :].max() == 255


def test_reduce_rolling_float32_within_one_count():
    """float32 frames: the cumulative sums may round in different orders, so a pixel on a
    truncation boundary may differ by one count; fewer than 0.1 % of the pixels do."""
    frames = _frames("float32", seed=7)
    want = np.asarray(jflt.reduce_rolling(frames, 4)).astype(np.int16)
    got = tflt.reduce_rolling(torch.as_tensor(frames), 4).numpy().astype(np.int16)
    assert np.abs(got - want).max() <= 1
    assert (got != want).mean() < 1e-3


# -- the accessor methods -----------------------------------------------------------


@pytest.fixture(scope="module")
def stacks():
    """(port frames, JAX frames, port cc, JAX cc) per dtype: the same in-memory stack in both packages."""
    pyorc_tpu_torch.set_device("cpu")
    cc_t = chip_smoke.nadir_camera_config(H_IMG, W_IMG, gcp_px=30, aoi_px=40)
    cc_j = pyorc_tpu.get_camera_config(cc_t.to_json())
    out = {}
    for dtype in ("uint8", "float32"):
        stack = _frames(dtype, seed=11, shape=(T, H_IMG, W_IMG))
        out[dtype] = (
            chip_smoke.frames_dataarray(stack, cc_t), chip_smoke.frames_dataarray(stack, cc_j, pyorc_tpu), cc_t, cc_j
        )
    return out


def _hold_frames(got, want, atol=None):
    """Two frames DataArrays of the two packages: dims, dtype, name, attrs, every coord; values equal or within atol."""
    assert isinstance(got, pyorc_tpu_torch.DataArray)
    assert got.dims == want.dims and got.name == want.name and got.attrs == want.attrs
    assert got.values.dtype == np.asarray(want.values).dtype
    assert set(got.coords) == set(want.coords)
    for name in want.coords:
        assert got[name].dims == want[name].dims, name
        np.testing.assert_array_equal(got[name].values, want[name].values, err_msg=name)
    if atol is None:
        np.testing.assert_array_equal(got.values, np.asarray(want.values))
    else:
        np.testing.assert_allclose(got.values, np.asarray(want.values), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize(
    "method,kwargs,atol",
    [
        ("smooth", {}, 1e-3),
        ("smooth", {"wdw": 4}, 1e-3),
        ("edge_detect", {}, 1e-3),
        ("edge_detect", {"wdw_1": 2, "wdw_2": 5}, 1e-3),
        ("minmax", {"min": 50, "max": 200.0}, None),
        ("minmax", {}, None),
        ("time_diff", {}, None),
        ("time_diff", {"thres": 3.0, "abs": True}, None),
        ("range", {}, None),
        ("reduce_rolling", {"samples": 4}, "rolling"),
    ],
    ids=["smooth", "smooth-9px", "edge", "edge-5-11px", "minmax", "minmax-open", "time_diff", "time_diff-abs",
         "range", "reduce_rolling"],
)
def test_accessor_method_matches_jax(stacks, dtype, method, kwargs, atol):
    """Each Frames filter method against its JAX twin on the same stack: values (1e-3 for the
    blurs, else exact), dtype, dims, attrs and coords (time_diff drops the first time,
    range the whole time axis)."""
    da_t, da_j, _, _ = stacks[dtype]
    if atol == "rolling":  # exact for uint8, within one count for float32 (see above)
        atol = None if dtype == "uint8" else 1
    got = getattr(da_t.frames, method)(**kwargs)
    want = getattr(da_j.frames, method)(**kwargs)
    _hold_frames(got, want, atol)
    if method == "time_diff":
        assert got.shape[0] == T - 1
        np.testing.assert_array_equal(got["time"].values, da_t["time"].values[1:])
    if method == "range":
        assert got.dims == ("y", "x") and "time" not in got.coords


def test_filters_chain_into_project_and_stiv(stacks):
    """Filtered frames keep what the next stage reads: smooth -> project -> smooth -> get_stiv runs."""
    da_t, _, cc_t, _ = stacks["uint8"]
    proj = da_t.frames.smooth().frames.project()
    assert proj.values.dtype == np.float32 and proj.frames.is_projected
    ds = proj.frames.smooth(wdw=2).frames.get_stiv(
        np.array([[W_IMG * chip_smoke.RES / 2, H_IMG * chip_smoke.RES / 2]]), angle=0.3, length=0.8
    )
    assert ds["v"].dims == ("line",) and np.isfinite(ds["coherence"].values).all()


def test_reduce_rolling_needs_enough_frames(stacks):
    with pytest.raises(ValueError, match="rolling"):
        stacks["uint8"][0].frames.reduce_rolling(samples=T + 1)


# -- RGB frames -----------------------------------------------------------


@pytest.fixture(scope="module")
def rgb_stacks(stacks):
    """An RGB stack [4, H_IMG, W_IMG, 3] uint8 as frames of both packages."""
    _, _, cc_t, cc_j = stacks["uint8"]
    stack = _frames("uint8", seed=13, shape=(4, H_IMG, W_IMG, 3))
    out = []
    for cc, pkg in ((cc_t, pyorc_tpu_torch), (cc_j, pyorc_tpu)):
        gray = chip_smoke.frames_dataarray(stack[..., 0], cc, pkg)
        da = pkg.ndx.DataArray(
            stack, dims=("time", "y", "x", "rgb"), coords={k: gray[k].values for k in ("time", "y", "x")},
            attrs=dict(gray.attrs), name="frames",
        )
        for name in ("xp", "yp"):
            da._coords[name] = gray._coords[name]
        out.append(da)
    return out


def test_rgb_project_matches_jax(rgb_stacks, stacks):
    """RGB frames project band by band: the JAX package's bytes, dims (time, y, x, rgb) and coords;
    each band is the gray projection of that band."""
    da_t, da_j = rgb_stacks
    got, want = da_t.frames.project(), da_j.frames.project()
    assert got.dims == ("time", "y", "x", "rgb") and got.values.dtype == np.uint8
    _hold_frames(got, want)
    cc_t = stacks["uint8"][2]
    band = chip_smoke.frames_dataarray(np.ascontiguousarray(da_t.values[..., 1]), cc_t).frames.project()
    np.testing.assert_array_equal(got.values[..., 1], band.values)


@pytest.mark.parametrize(
    "method,kwargs",
    [("minmax", {"min": 30.0, "max": 190.0}), ("time_diff", {"thres": 1.0}), ("range", {})],
)
def test_rgb_shape_agnostic_filters_match_jax(rgb_stacks, method, kwargs):
    da_t, da_j = rgb_stacks
    _hold_frames(getattr(da_t.frames, method)(**kwargs), getattr(da_j.frames, method)(**kwargs))


@pytest.mark.parametrize(
    "bounds", [{"min": 300}, {"max": -5}, {"min": 300, "max": 400}, {"min": -5, "max": 300}, {"min": 10.7, "max": 200.2}],
    ids=["min-300", "max--5", "both-above", "both-outside", "fractional"],
)
def test_minmax_bounds_outside_the_dtype_follow_jax(stacks, bounds):
    """``minmax`` on uint8 frames with bounds outside 0-255 saturates as the JAX package's
    cast does (min=300 gives 255, max=-5 gives 0); a plain cast would wrap (300 -> 44).
    In memory and on the lazy chain's device batches alike."""
    da_t, da_j = stacks["uint8"][:2]
    got = da_t.frames.minmax(**bounds)
    _hold_frames(got, da_j.frames.minmax(**bounds))
    if "min" in bounds and bounds["min"] >= 255:
        assert (got.values == 255).all()
    lazy = chip_smoke.lazy_dataarray(chip_smoke.HostFrameSource(da_t.values), stacks["uint8"][2], chip_smoke.FPS)
    np.testing.assert_array_equal(lazy.frames.minmax(**bounds).frames.project().values, got.frames.project().values)


@pytest.mark.parametrize("nan_at", ["one-frame", "every-frame", "none"])
def test_range_with_nan_follows_jax(stacks, nan_at):
    """``range`` on float frames with NaN: a pixel with NaN in any frame reads NaN, as in the JAX package."""
    da_t, da_j = stacks["float32"][:2]
    values = da_t.values.copy()
    if nan_at == "one-frame":
        values[2, 10, 20] = np.nan
    elif nan_at == "every-frame":
        values[:, 30, 40] = np.nan
    got = da_t._replace(values).frames.range()
    _hold_frames(got, da_j._replace(values).frames.range())
    assert np.isnan(got.values).sum() == (0 if nan_at == "none" else 1)


@pytest.mark.parametrize(
    "method,kwargs,jax_raises",
    [
        ("smooth", {}, "pad_width"),
        ("edge_detect", {}, "pad_width"),
        ("reduce_rolling", {"samples": 2}, "broadcasting"),
        ("normalize", {"samples": 2}, None),
    ],
)
def test_rgb_filters_the_jax_package_lacks(rgb_stacks, method, kwargs, jax_raises):
    """On an RGB stack the JAX package's smooth, edge_detect and reduce_rolling raise, and its
    normalize rescales every image row by the extrema over (x, rgb) instead of every frame;
    the port refuses all four and says so."""
    da_t, da_j = rgb_stacks
    with pytest.raises(NotImplementedError, match="gray frames"):
        getattr(da_t.frames, method)(**kwargs)
    if jax_raises:
        with pytest.raises(ValueError, match=jax_raises):
            getattr(da_j.frames, method)(**kwargs)
    else:
        rows = np.asarray(da_j.frames.normalize(**kwargs).values)
        assert (rows.min(axis=(-2, -1)) == 0).all()  # every row of every frame reaches 0: per-row rescaling


# -- get_piv's default overlap -----------------------------------------------------------


@pytest.mark.parametrize("window_size,step", [((16, 32), (8, 16)), ((15, 25), (9, 14)), (15, (9, 9))])
def test_get_piv_default_overlap_per_axis(stacks, window_size, step):
    """overlap=None takes int(round(w) / 2) of the configured size on each axis; a (y, x)
    window_size used to fail at round(tuple). The grid is that of the explicit overlap."""
    da_t = stacks["uint8"][0]
    proj = da_t.frames.project()[:3]
    got = proj.frames.get_piv(window_size=window_size)
    ws = (window_size, window_size) if isinstance(window_size, int) else window_size
    ws = tuple(w + w % 2 for w in ws)
    want = proj.frames.get_piv(window_size=window_size, overlap=(ws[0] - step[0], ws[1] - step[1]))
    assert got["v_x"].values.shape == want["v_x"].values.shape
    np.testing.assert_array_equal(got["y"].values, want["y"].values)
    np.testing.assert_array_equal(got["x"].values, want["x"].values)
    np.testing.assert_array_equal(got["v_x"].values, want["v_x"].values)
