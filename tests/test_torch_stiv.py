"""The port's STIV (``ops/stiv.py``, ``Frames.get_stiv``) against the JAX
package on the CPU, on the advected texture of ``tests/test_stiv.py``."""

import json

import jax
import numpy as np
import pytest
import torch

import pyorc_tpu
from pyorc_tpu.ops import stiv as jstiv

import pyorc_tpu_torch
from pyorc_tpu_torch.ops import stiv as tstiv

T_LEN, H, W = 40, 128, 256
CENTERS = np.array([[128.0, 40.0], [128.0, 64.0], [128.3, 90.6]])
# v is compared where JAX's coherence exceeds this: below it the structure
# tensor is near isotropic and the streak angle a near-tie (no case here)
COH_MIN = 0.2


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def advect():
    """frames(vpx): a smooth random texture moving vpx px/frame along +x, float32 [40, 128, 256]."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(3)
    base = gaussian_filter(rng.normal(size=(H, W * 2)), 2.0)
    yy, xg = np.mgrid[0:H, 0:W].astype(float)
    made = {}

    def make(vpx):
        if vpx not in made:
            frames = np.zeros((T_LEN, H, W), np.float32)
            for t in range(T_LEN):
                frames[t] = map_coordinates(base, [yy, xg - vpx * t + W / 2], order=1, mode="wrap")
            made[vpx] = frames
        return made[vpx]

    return make


@pytest.fixture(scope="module")
def sti(advect):
    """The STI of three slightly tilted lines over the 1.5 px/frame stack, from the JAX package."""
    rows, cols = jstiv.stiv_lines(CENTERS, 0.05, 200, 200)
    return np.array(jstiv.build_sti(advect(1.5), rows, cols))  # a writable copy: torch.as_tensor shares it


def test_stiv_lines_equal():
    for angle in (0.0, 0.3, np.pi / 2, np.pi):
        want = jstiv.stiv_lines(CENTERS, angle, 80.0, 41)
        got = tstiv.stiv_lines(CENTERS, angle, 80.0, 41)
        for a, b in zip(got, want):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_build_sti(advect, dtype):
    """Same points, same frames: within 1e-6 of the value range (float32 rounding of four products)."""
    frames = advect(0.8)
    if dtype == "uint8":
        frames = np.clip(frames * 200 + 128, 0, 255).astype(np.uint8)
    # lines that leave the frame on both sides: the edge clamp is exercised
    rows, cols = jstiv.stiv_lines(np.array([[128.0, 64.2], [20.0, 5.0], [250.0, 120.0]]), 0.4, 120, 97)
    want = np.asarray(jstiv.build_sti(frames, rows, cols))
    got = tstiv.build_sti(torch.as_tensor(frames), rows, cols)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, T_LEN, 97)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * float(np.abs(want).max()))
    # JAX's build_sti is jitted, and XLA's CPU build sums each sample as chain B (ops/interp.py)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # sampled in batches of frames, as get_stiv does: the same values
    parts = [tstiv.build_sti(torch.as_tensor(frames[s : s + 16]), rows, cols) for s in range(0, T_LEN, 16)]
    assert torch.equal(torch.cat(parts, dim=1), got)


@pytest.mark.parametrize("size,axis", [(1, -1), (4, -1), (31, -1), (5, 1), (250, -1)])
def test_box_smooth_1d(sti, size, axis):
    """Edge-padded box mean by cumulative sum: 1e-6 absolute on values below 0.5
    (the two cumulative sums may round in different orders)."""
    want = np.asarray(jstiv._box_smooth_1d(sti, size, axis))
    got = tstiv._box_smooth_1d(torch.as_tensor(sti), size, axis).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size,shape,axis", [(4, (128, 404), -1), (5, (128, 404), -1), (21, (3, 40, 97), 1),
                                             (31, (7, 1000), -1), (250, (3, 97), -1)])
def test_box_smooth_1d_matches_jitted_jax(size, shape, axis):
    """Bit for bit JAX's jitted box filter (its callers are jitted): XLA's CPU build sums the
    cumulative sum in blocks of 16 and multiplies by the float32 reciprocal of ``size``."""
    x = np.random.default_rng(size).normal(0.0, 50.0, shape).astype(np.float32)
    want = np.asarray(jax.jit(jstiv._box_smooth_1d, static_argnums=(1, 2))(x, size, axis))
    got = tstiv._box_smooth_1d(torch.as_tensor(x), size, axis).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("window", [0, 31])
@pytest.mark.parametrize("with_valid", [False, True])
def test_sti_orientation(sti, window, with_valid):
    """Slope within 1e-4 relative where coherent, coherence within 1e-5, equal NaN masks."""
    s = sti - sti.mean(axis=-2, keepdims=True)
    valid = None
    if with_valid:
        # the margin a shear would invalidate, wide enough that some profile points fall under one half
        valid = np.ones_like(s)
        valid[:, :, :30] = 0.0
        valid[:, 10:, 150:] = 0.0
    m_j, c_j = (np.asarray(a) for a in jstiv._sti_orientation(s, window, valid))
    m_t, c_t = tstiv._sti_orientation(torch.as_tensor(s), window, None if valid is None else torch.as_tensor(valid))
    m_t, c_t = m_t.numpy(), c_t.numpy()
    np.testing.assert_array_equal(np.isnan(m_t), np.isnan(m_j))
    if with_valid and window:
        assert np.isnan(m_j).any() and (c_j[np.isnan(m_j)] == 0).all()
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=1e-5)
    good = c_j > COH_MIN
    assert good.any()
    np.testing.assert_allclose(m_t[good], m_j[good], rtol=1e-4)


def test_shear_sti(sti):
    """De-sheared STI within 1e-6 absolute, validity masks equal; a NaN-free slope per line."""
    m = np.array([1.5, -0.7, 3.2], np.float32)
    out_j, valid_j = (np.asarray(a) for a in jstiv._shear_sti(sti, m))
    out_t, valid_t = tstiv._shear_sti(torch.as_tensor(sti), torch.as_tensor(m))
    np.testing.assert_array_equal(valid_t.numpy(), valid_j)
    assert 0 < valid_j.mean() < 1
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("vpx", [0.8, -1.2, 1.5])
@pytest.mark.parametrize("window,refine", [(0, 0), (0, 2), (31, 0), (31, 2)])
def test_sti_velocity(advect, vpx, window, refine):
    """v within 1e-3 relative where JAX's coherence > COH_MIN, coherence within 1e-4;
    the line spacing and dt are not representable, so step_px / dt must divide in float32."""
    rows, cols = jstiv.stiv_lines(CENTERS, 0.0, 200, 200)
    s = np.asarray(jstiv.build_sti(advect(vpx), rows, cols))
    step_px, dt = 200 / 199, 0.16
    v_j, c_j = (np.asarray(a) for a in jstiv.sti_velocity(s, step_px, dt, window, refine))
    v_t, c_t = tstiv.sti_velocity(torch.as_tensor(s), step_px, dt, window, refine)
    v_t, c_t = v_t.numpy(), c_t.numpy()
    assert v_t.shape == v_j.shape == ((3, 200) if window else (3,))
    np.testing.assert_array_equal(np.isnan(v_t), np.isnan(v_j))
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=1e-4)
    good = c_j > COH_MIN
    assert good.mean() > 0.9
    np.testing.assert_allclose(v_t[good], v_j[good], rtol=1e-3)
    if window == 0 and refine == 2:  # the oracle of tests/test_stiv.py holds for the port
        np.testing.assert_allclose(v_t * dt, vpx, atol=0.05 * max(abs(vpx), 1))
        assert (c_t > 0.5).all()


def test_sti_velocity_no_texture(advect):
    """A static scene leaves float32 summation noise after background removal: the contract is
    coherence < 0.01 and v NaN where JAX's is. The ``trace > 1e-12`` gate decides the NaN; the
    tensor's trace is below 1e-14 in both packages here, two orders under the gate on either side."""
    import jax.numpy as jnp

    rows, cols = jstiv.stiv_lines(np.array([[128.0, 64.0]]), 0.0, 200, 200)
    s = np.asarray(jstiv.build_sti(advect(0.0), rows, cols))
    v_j, c_j = (np.asarray(a) for a in jstiv.sti_velocity(s, 1.0, 1.0))
    v_t, c_t = tstiv.sti_velocity(torch.as_tensor(s.copy()), 1.0, 1.0)
    centred_j = jnp.asarray(s) - jnp.mean(jnp.asarray(s), axis=-2, keepdims=True)
    trace_j = float(sum(jnp.mean(g * g) for g in jnp.gradient(centred_j, axis=(-2, -1))))
    centred_t = torch.as_tensor(s.copy()) - torch.as_tensor(s.copy()).mean(dim=-2, keepdim=True)
    trace_t = float(sum((g * g).mean() for g in torch.gradient(centred_t, dim=(-2, -1))))
    assert trace_j < 1e-14 and trace_t < 1e-14, (trace_j, trace_t)
    assert (c_t.numpy() < 0.01).all() and (c_j < 0.01).all()
    np.testing.assert_array_equal(np.isnan(v_t.numpy()), np.isnan(v_j))
    assert np.isnan(v_t.numpy()).all()


def _projected(frames_np, pkg):
    """The synthetic projected frames DataArray of tests/test_stiv.py:70-91 in ``pkg``."""
    t_len, h, w = frames_np.shape
    res, fps = 0.02, 25.0
    x = (np.arange(w) + 0.5) * res
    y = ((np.arange(h) + 0.5) * res)[::-1]
    xs, ys = np.meshgrid(x, y)
    cc = {"height": h, "width": w, "resolution": res, "window_size": 32}
    return pkg.ndx.DataArray(
        frames_np,
        dims=("time", "y", "x"),
        coords={"time": np.arange(t_len) / fps, "y": y, "x": x, "xs": (("y", "x"), xs), "ys": (("y", "x"), ys)},
        attrs={"camera_config": json.dumps(cc), "camera_shape": str([h, w])},
        name="frames",
    )


@pytest.mark.parametrize(
    "dtype,kwargs",
    [
        ("float32", {"angle": 0.0}),
        ("float32", {"angle": np.pi}),
        ("float32", {"angle": 0.2, "n_samples": 120, "refine": 0}),
        ("float32", {"angle": 0.0, "window": 21}),
        ("uint8", {"angle": 0.0}),
        ("uint8", {"angle": 0.0, "window": 21, "min_coherence": 0.9}),
    ],
    ids=["along", "against", "tilted-coarse", "profile", "uint8", "uint8-profile-gated"],
)
def test_get_stiv_matches_jax(advect, dtype, kwargs):
    """get_stiv through both packages on the same projected stack: the same Dataset
    (names, dims, coords, attrs), v within 1e-3 relative where JAX's coherence > COH_MIN
    (NaN in the same places), coherence within 1e-4."""
    frames = advect(1.0)
    if dtype == "uint8":
        frames = np.clip(frames * 200 + 128, 0, 255).astype(np.uint8)
    res, fps = 0.02, 25.0
    centers = np.array([[W * res / 2, H * res / 2], [W * res / 2 + 0.11, H * res / 3]])
    ds_j = _projected(frames, pyorc_tpu).frames.get_stiv(centers, length=3.0, **kwargs)
    ds_t = _projected(frames, pyorc_tpu_torch).frames.get_stiv(centers, length=3.0, **kwargs)
    assert isinstance(ds_t, pyorc_tpu_torch.Dataset)
    assert list(ds_t.data_vars) == list(ds_j.data_vars) == ["v", "coherence"]
    assert set(ds_t.coords) == set(ds_j.coords)
    assert ds_t.attrs == ds_j.attrs
    for name in ("v", "coherence"):
        assert ds_t[name].dims == ds_j[name].dims
        assert ds_t[name].values.dtype == np.float32
        assert ds_t[name].attrs == ds_j[name].attrs
    for name in ds_j.coords:
        np.testing.assert_array_equal(ds_t[name].values, ds_j[name].values)
    v_j, c_j = ds_j["v"].values, ds_j["coherence"].values
    v_t, c_t = ds_t["v"].values, ds_t["coherence"].values
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=1e-4)
    # a gate exactly at min_coherence may flip where the coherences differ by rounding
    near_gate = np.abs(c_j - kwargs.get("min_coherence", -1.0)) < 1e-4
    np.testing.assert_array_equal(np.isnan(v_t)[~near_gate], np.isnan(v_j)[~near_gate])
    good = (c_j > COH_MIN) & ~np.isnan(v_j) & ~near_gate
    assert good.any()
    np.testing.assert_allclose(v_t[good], v_j[good], rtol=1e-3)
    if "window" not in kwargs and "n_samples" not in kwargs:
        # 1 px/frame toward +x: res * fps m/s, signed by the line's direction
        sign = 1.0 if kwargs["angle"] == 0.0 else -1.0
        np.testing.assert_allclose(v_t, sign * res * fps, rtol=0.05)
        assert (c_t > 0.5).all()


def test_get_stiv_needs_projected_gray_frames(advect):
    da = _projected(advect(1.0)[:4], pyorc_tpu_torch)
    unprojected = pyorc_tpu_torch.DataArray(
        da.values, dims=da.dims, coords={k: da[k].values for k in ("time", "y", "x")}, attrs=dict(da.attrs)
    )
    with pytest.raises(ValueError, match="projected"):
        unprojected.frames.get_stiv(np.array([[2.0, 1.0]]), angle=0.0, length=1.0)
