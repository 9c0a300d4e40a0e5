"""The port's plotting and UGRID export against the JAX package on the CPU.

One velocimetry Dataset is built from numpy with a seed (the coordinates that
``Frames.get_piv`` attaches, from ``get_piv_coords`` of a small projected scene
with a CRS; v_x, v_y, s2n and corr random, with NaNs) and wrapped in each
package's ``ndx``; one transect Dataset comes from each package's
``get_transect`` -> ``get_q`` on it. Then the ``get_uv_*`` accessors, every
plot method in every mode (rendered with Agg into an RGBA buffer), ``to_ugrid``,
the basemap (driven through ``fetch=``, offline) and ``plot_helpers`` must
equal JAX's. The two packages draw the same arrays, so the buffers must be
equal to the byte.
"""

import json
import warnings

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyorc_tpu  # noqa: E402
from pyorc_tpu.api import plot as jplot  # noqa: E402
from pyorc_tpu.io import basemap as jbasemap  # noqa: E402

import pyorc_tpu_torch  # noqa: E402
from pyorc_tpu_torch.api import plot as tplot  # noqa: E402
from pyorc_tpu_torch.io import basemap as tbasemap  # noqa: E402

import chip_smoke  # noqa: E402

H, W = 96, 128
X0, Y0 = 500000.0, 5700000.0
WINDOW, OVERLAP = 16, 8
PKGS = {"torch": pyorc_tpu_torch, "jax": pyorc_tpu}


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)
    yield
    plt.close("all")


def _camera_json():
    cc = chip_smoke.nadir_camera_config(H, W, gcp_px=12, aoi_px=16)
    d = json.loads(cc.to_json())
    d["crs"] = 32631
    d["gcps"]["dst"] = [[X0 + x, Y0 + y] for x, y in d["gcps"]["dst"]]
    d["lens_position"] = [X0 + 0.64, Y0 + 0.48, 10.0]
    d.pop("bbox", None)
    d.pop("is_nadir", None)
    out = pyorc_tpu_torch.CameraConfig(**d)
    out.set_bbox_from_corners([[16, 16], [W - 16, 16], [W - 16, H - 16], [16, H - 16]])
    return out.to_json()


def velocimetry_dataset(pkg, cc_json, n_time=3, seed=11):
    """A Dataset as ``Frames.get_piv`` returns it, with random fields of a seed, in ``pkg``'s ndx."""
    stack = np.zeros((2, H, W), np.uint8)
    cc = pkg.api.cameraconfig.get_camera_config(cc_json)
    proj = chip_smoke.frames_dataarray(stack, cc, pkg=pkg).frames.project()
    coords, mesh = proj.frames.get_piv_coords((WINDOW, WINDOW), (WINDOW, WINDOW), (OVERLAP, OVERLAP))
    shape = (n_time, len(coords["y"]), len(coords["x"]))
    rng = np.random.default_rng(seed)
    fields = {
        "v_x": 0.3 + 0.05 * rng.normal(size=shape),
        "v_y": -0.1 + 0.05 * rng.normal(size=shape),
        "s2n": rng.uniform(1.0, 8.0, size=shape),
        "corr": rng.uniform(0.2, 1.0, size=shape),
    }
    for a in fields.values():
        a[rng.uniform(size=shape) < 0.1] = np.nan
    ds = pkg.ndx.Dataset(
        {k: (("time", "y", "x"), v.astype(np.float32)) for k, v in fields.items()},
        coords={"time": np.arange(n_time) / 6.25, **coords},
    )
    ds = ds.velocimetry.add_xy_coords(mesh, coords, {**pkg.const.PERSPECTIVE_ATTRS, **pkg.const.GEOGRAPHICAL_ATTRS})
    ds.attrs = dict(proj.attrs)
    return ds


@pytest.fixture(scope="module")
def data():
    """{name: (velocimetry Dataset, reduced Dataset, transect Dataset at the median quantile)}."""
    pyorc_tpu_torch.set_device("cpu")
    cc_json = _camera_json()
    out = {}
    for name, pkg in PKGS.items():
        ds = velocimetry_dataset(pkg, cc_json)
        reduced = ds.mean(dim="time")
        reduced.attrs = dict(ds.attrs)
        xv, yv = ds["x"].values, ds["y"].values
        x = X0 + np.full(9, float(xv.mean()))
        y = Y0 + np.linspace(float(yv.min()) + 0.1, float(yv.max()) - 0.1, 9)
        z = -0.4 * (1.0 - np.linspace(-1.0, 1.0, 9) ** 2) + 0.05
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            tr = ds.velocimetry.get_transect(x, y, z, crs=32631).transect.get_q(fill_method="zeros")
        trq = tr.isel(quantile=2)
        trq.attrs = dict(tr.attrs)
        out[name] = (ds, reduced, trq)
    return out


def _rgba(ax):
    fig = ax.figure
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def _small_ax():
    return plt.subplots(figsize=(3.2, 2.4), dpi=50)[1]


def test_get_uv_equal_jax(data):
    """``get_uv_local``, ``get_uv_geographical`` and ``get_uv_camera`` on both plot namespaces."""
    for index in (1, 2):  # the reduced velocimetry field, the transect
        got, want = data["torch"][index], data["jax"][index]
        ns_got = got.velocimetry.plot if index == 1 else got.transect.plot
        ns_want = want.velocimetry.plot if index == 1 else want.transect.plot
        for name in ("get_uv_local", "get_uv_geographical", "get_uv_camera"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for a, b in zip(getattr(ns_got, name)(), getattr(ns_want, name)()):
                    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
                    assert np.isfinite(np.asarray(a)).any(), name


@pytest.mark.parametrize("method", ["quiver", "pcolormesh", "scatter"])
@pytest.mark.parametrize("mode", ["local", "geographical", "camera"])
def test_velocimetry_plot_rgba_equal_jax(data, method, mode):
    """Each velocimetry plot method in each mode renders JAX's pixels (with a colorbar)."""
    buffers = []
    for name in ("torch", "jax"):
        ax = data[name][1].velocimetry.plot(method=method, mode=mode, ax=_small_ax(), add_colorbar=True,
                                            colorbar_loc=1)
        buffers.append(_rgba(ax))
    np.testing.assert_array_equal(buffers[0], buffers[1])
    assert (buffers[0][..., :3] < 250).any()  # something was drawn


def test_streamplot_and_default_axes_equal_jax(data):
    """``streamplot`` (local only) and the default call (quiver on a new 13 x 8 in figure)."""
    for call in (lambda ds: ds.velocimetry.plot.streamplot(ax=_small_ax(), linewidth_scale=3.0, density=0.5),
                 lambda ds: ds.velocimetry.plot()):
        buffers = [_rgba(call(data[name][1])) for name in ("torch", "jax")]
        np.testing.assert_array_equal(buffers[0], buffers[1])
    with pytest.raises(ValueError, match="local"):
        data["torch"][1].velocimetry.plot.streamplot(mode="camera")
    with pytest.raises(AttributeError, match="Reduce"):
        data["torch"][0].velocimetry.plot(method="quiver")


@pytest.mark.parametrize("method", ["quiver", "scatter"])
@pytest.mark.parametrize("mode", ["local", "geographical", "camera"])
def test_transect_plot_rgba_equal_jax(data, method, mode):
    """The transect's quiver and scatter with their overlays (cross-section line, or the camera
    view's wetted surface, water level and depth lines) and the discharge text."""
    buffers = []
    for name in ("torch", "jax"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ax = data[name][2].transect.plot(method=method, mode=mode, ax=_small_ax(), add_colorbar=True,
                                             add_text=True, text_prefix="t: ")
        buffers.append(_rgba(ax))
    np.testing.assert_array_equal(buffers[0], buffers[1])


def test_frames_plot_rgba_equal_jax(data):
    """``Frames.plot`` of one projected frame in local, geographical and camera modes, gray and
    RGB; a stack with time raises, as in JAX."""
    rng = np.random.default_rng(2)
    cc_json = data["torch"][0].attrs["camera_config"]
    gray = rng.integers(0, 256, (2, H, W), dtype=np.uint8)
    frames = {}
    for name, pkg in PKGS.items():
        cc = pkg.api.cameraconfig.get_camera_config(cc_json)
        da = chip_smoke.frames_dataarray(gray, cc, pkg=pkg)
        frames[name] = {"camera": da.isel(time=0), "proj": da.frames.project().isel(time=0)}
        rgb = pkg.ndx.DataArray(
            np.stack([gray] * 3, axis=-1), dims=("time", "y", "x", "rgb"),
            coords={k: da[k].values for k in ("time", "y", "x")}, attrs=dict(da.attrs), name="frames",
        )
        frames[name]["rgb"] = rgb.frames.project().isel(time=0)
    for key, mode in (("proj", "local"), ("proj", "geographical"), ("camera", "camera"), ("rgb", "local")):
        buffers = [_rgba(frames[name][key].frames.plot(ax=_small_ax(), mode=mode)) for name in PKGS]
        np.testing.assert_array_equal(buffers[0], buffers[1], err_msg=f"{key} {mode}")
    with pytest.raises(AttributeError, match="Reduce"):
        tplot.frames_plot(chip_smoke.frames_dataarray(gray, pyorc_tpu_torch.api.cameraconfig.get_camera_config(cc_json)))


def test_cbar_and_plot_text_equal_jax(data):
    """``cbar`` at each location and ``plot_text`` (a no-op without ``q``)."""
    buffers = []
    for name, mod in (("torch", tplot), ("jax", jplot)):
        ax = _small_ax()
        p = ax.scatter([0, 1, 2], [0, 1, 2], c=[0.1, 0.2, 0.3])
        for loc in range(4):
            mod.cbar(ax, p, size=6, loc=loc)
        assert mod.plot_text(ax, data[name][1]) is None
        mod.plot_text(ax, data[name][2], prefix="p ", suffix=" s")
        buffers.append(_rgba(ax))
    np.testing.assert_array_equal(buffers[0], buffers[1])


def test_to_ugrid_equals_jax(data, tmp_path):
    """``Velocimetry.to_ugrid``: arrays, encoding and attributes of JAX's (but the timestamps)."""
    for fill_na in (None, -999.0):
        got = data["torch"][0].velocimetry.to_ugrid(fill_na=fill_na, title="t")
        want = data["jax"][0].velocimetry.to_ugrid(fill_na=fill_na, title="t")
        assert set(got.data_vars) == set(want.data_vars) and set(got.coords) == set(want.coords)
        for k in list(want.data_vars) + list(want.coords):
            np.testing.assert_array_equal(got[k].values, np.asarray(want[k].values), err_msg=k)
            assert got[k].dims == want[k].dims and got[k].values.dtype == np.asarray(want[k].values).dtype, k
            assert got[k].attrs == want[k].attrs, k
        assert got.encoding == want.encoding
        stamps = ("date_created", "history")
        assert {k: v for k, v in got.attrs.items() if k not in stamps} == {
            k: v for k, v in want.attrs.items() if k not in stamps
        }
        assert set(got.attrs) == set(want.attrs)
    got.to_netcdf(tmp_path / "ugrid.nc")
    back = pyorc_tpu.open_dataset(tmp_path / "ugrid.nc")
    np.testing.assert_array_equal(np.asarray(back["mesh2d_ucx"].values), got["mesh2d_ucx"].values)


def _synthetic_fetch(provider, x, y, z):
    t = np.zeros((256, 256, 3), np.uint8)
    t[..., 0] = (x % 2) * 200 + 30
    t[..., 1] = (y % 2) * 200 + 30
    t[..., 2] = z
    return t


def test_basemap_equal_jax(tmp_path, monkeypatch):
    """Tile math, the mosaic through ``fetch=``, and the offline fallback with JAX's warning."""
    monkeypatch.setenv("PYORC_TPU_TILE_CACHE", str(tmp_path))
    for lon, lat, z in [(5.9135, 50.807, 18), (-122.4, 37.77, 15)]:
        assert tbasemap._lonlat_to_tilef(lon, lat, z) == jbasemap._lonlat_to_tilef(lon, lat, z)
        assert tbasemap._tilef_to_lonlat(3.5, 7.25, z) == jbasemap._tilef_to_lonlat(3.5, 7.25, z)
    assert tbasemap._quadkey(5, 9, 6) == jbasemap._quadkey(5, 9, 6)
    extent = (5.9130, 5.9140, 50.8068, 50.8074)
    got = tbasemap.tile_mosaic(extent, zoom=18, fetch=_synthetic_fetch)
    want = jbasemap.tile_mosaic(extent, zoom=18, fetch=_synthetic_fetch)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    buffers = []
    for mod in (tbasemap, jbasemap):
        ax = _small_ax()
        assert mod.add_basemap(ax, extent, fetch=_synthetic_fetch)
        buffers.append(_rgba(ax))
        with pytest.warns(UserWarning, match="Basemap tiles unavailable"):
            assert not mod.add_basemap(_small_ax(), extent, fetch=lambda *a: None)
        with pytest.warns(UserWarning, match="lower the zoom"):
            assert not mod.add_basemap(_small_ax(), (5.0, 6.0, 50.0, 51.0), fetch=_synthetic_fetch)
    np.testing.assert_array_equal(buffers[0], buffers[1])


def test_geo_axes_and_helpers_equal_jax(monkeypatch):
    """``helpers.get_geo_axes`` with tiles (offline through a patched fetcher) and the helpers
    kept beside it."""
    from pyorc_tpu import helpers as jhelpers

    from pyorc_tpu_torch import helpers as thelpers

    monkeypatch.setattr(tbasemap, "_fetch_tile", _synthetic_fetch)
    monkeypatch.setattr(jbasemap, "_fetch_tile", _synthetic_fetch)
    buffers = []
    for mod in (thelpers, jhelpers):
        plt.figure(figsize=(3.2, 2.4), dpi=50)
        buffers.append(_rgba(mod.get_geo_axes(tiles="GoogleTiles", extent=(5.913, 5.914, 50.8068, 50.8074))))
    np.testing.assert_array_equal(buffers[0], buffers[1])
    assert thelpers.staggered_index(0, 40) == jhelpers.staggered_index(0, 40)
    assert thelpers.get_rotation_code(None) is None and thelpers.get_rotation_code(90) == jhelpers.get_rotation_code(90)
    with pytest.raises(ValueError):
        thelpers.get_rotation_code(45)


def test_plot_helpers_equal_jax():
    """``plot_helpers`` draws in-tree geometries as JAX's does, 2-D and 3-D."""
    from pyorc_tpu import plot_helpers as jph
    from pyorc_tpu.geom import shapes as jshapes

    from pyorc_tpu_torch import plot_helpers as tph
    from pyorc_tpu_torch.geom import shapes as tshapes

    buffers = []
    for ph, shapes in ((tph, tshapes), (jph, jshapes)):
        sq = shapes.Polygon([(0, 0, 1.0), (1, 0, 1.2), (1, 1, 1.1), (0, 1, 1.3)])
        line = shapes.LineString([(0, 0, 1.0), (1, 1, 2.0)])
        fig = plt.figure(figsize=(4, 2), dpi=50)
        ax = fig.add_subplot(1, 2, 1)
        ph.plot_polygon(shapes.MultiPolygon([sq]), ax=ax, alpha=0.4, label="aoi")
        ph.plot_line(line, ax=ax, color="r")
        ax3 = fig.add_subplot(1, 2, 2, projection="3d")
        ph.plot_3d_polygon(sq, ax=ax3, alpha=0.3)
        ph.plot_3d_line(line, ax=ax3)
        buffers.append(_rgba(ax))
    np.testing.assert_array_equal(buffers[0], buffers[1])
