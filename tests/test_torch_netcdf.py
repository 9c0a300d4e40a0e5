"""The port's netCDF-4 reader and writer (``io/netcdf.py`` over h5py,
``Dataset.to_netcdf``, ``open_dataset``): round trips, and files exchanged
with the JAX package both ways."""

import sys

import numpy as np
import pytest
import torch

import pyorc_tpu
import pyorc_tpu_torch

import chip_smoke

H_IMG, W_IMG, N_FRAMES = 240, 320, 4
SCALE = pyorc_tpu_torch.const.ENCODING_PARAMS["scale_factor"]


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


def _as_pkg(ds, pkg):
    """``ds`` rebuilt as a Dataset of ``pkg`` (variables, coords, attrs, encoding)."""
    new = pkg.ndx.Dataset(
        {k: (v.dims, np.asarray(v.values), dict(v.attrs)) for k, v in ds.data_vars.items()},
        coords={k: (c.dims, np.asarray(c.values), dict(c.attrs)) for k, c in ds.coords.items()},
        attrs=dict(ds.attrs),
    )
    new.encoding = {k: dict(v) for k, v in ds.encoding.items()}
    return new


@pytest.fixture(scope="module")
def datasets():
    """Datasets of the port as its stages write them: a PIV result with the int16 + scale
    encoding of ``set_encoding`` (NaN cells included), a STIV profile without encoding, and a
    variable on a dimension that has no coordinate."""
    pyorc_tpu_torch.set_device("cpu")
    cc = chip_smoke.nadir_camera_config(H_IMG, W_IMG, gcp_px=30, aoi_px=40)
    stack = chip_smoke.advected_stack(H_IMG, W_IMG, N_FRAMES, "cpu")
    proj = chip_smoke.frames_dataarray(stack, cc).frames.project()
    piv = proj.frames.get_piv(window_size=16, overlap=(8, 8))
    piv["v_x"].values[0, :2] = np.nan
    piv["s2n"].values[1, 3, 4] = np.nan
    assert set(piv.encoding) == {"v_x", "v_y", "s2n", "corr"}
    centers = np.array([[1.6, 1.2], [1.7, 1.0]])
    stiv = proj.frames.get_stiv(centers, angle=-0.5, length=0.6, window=5)
    bare = pyorc_tpu_torch.Dataset(
        {"q": (("time", "member"), np.arange(6, dtype=np.float64).reshape(3, 2), {"units": "m3 s-1"})},
        coords={"time": np.array([0.0, 0.5, 1.0])},
        attrs={"h_a": "0.0", "note": "a dimension without a coordinate"},
    )
    return {"piv": piv, "stiv": stiv, "bare": bare}


def _hold(back, ds):
    """``back`` (read from a file) against the dataset ``ds`` that was written."""
    assert not [d for d in back.sizes if d.startswith("phony_dim")], back.sizes
    assert dict(back.sizes) == dict(ds.sizes)
    assert set(back.data_vars) == set(ds.data_vars)
    # a dimension without a coordinate is written as a data-less dimension scale, which the reader
    # (in both packages) hands back as a float32 coordinate of zeros
    bare_dims = set(ds.sizes) - set(ds.coords)
    assert set(back.coords) == set(ds.coords) | bare_dims
    for d in bare_dims:
        assert back[d].values.dtype == np.float32 and not back[d].values.any()
    assert back.attrs == ds.attrs
    for name, c in ds.coords.items():
        assert back[name].dims == c.dims, name
        np.testing.assert_array_equal(back[name].values, np.asarray(c.values), err_msg=name)
        assert back[name].attrs == c.attrs, name
    for name, v in ds.data_vars.items():
        got, want = back[name].values, np.asarray(v.values)
        assert back[name].dims == v.dims, name
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
        if name in ds.encoding:
            # int16 with scale_factor: half a step, and float32 out
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=0.5 * SCALE * (1 + 1e-6), err_msg=name)
            enc = back.encoding[name]
            assert enc["dtype"] == "int16" and enc["scale_factor"] == SCALE and enc["_FillValue"] == -32768
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=name)
        kept = {k: a for k, a in back[name].attrs.items() if k != "coordinates"}
        assert kept == v.attrs, name


@pytest.mark.parametrize("which", ["piv", "stiv", "bare"])
def test_round_trip(datasets, tmp_path, which):
    ds = datasets[which]
    path = tmp_path / f"{which}.nc"
    ds.to_netcdf(path)
    back = pyorc_tpu_torch.open_dataset(path)
    assert isinstance(back, pyorc_tpu_torch.Dataset)
    _hold(back, ds)
    if which == "piv":
        # written again from what was read (the encoding travels with it): the same packed integers
        again = tmp_path / "again.nc"
        back.to_netcdf(again)
        second = pyorc_tpu_torch.open_dataset(again)
        for name in ds.data_vars:
            np.testing.assert_array_equal(second[name].values, back[name].values)
        raw = pyorc_tpu_torch.io.read_netcdf(path, decode_cf=False)
        assert raw["v_x"].values.dtype == np.int16 and (raw["v_x"].values[0, :2] == -32768).all()


@pytest.mark.parametrize("which", ["piv", "stiv", "bare"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_exchanged_with_the_jax_package(datasets, tmp_path, which, writer):
    """A file written by one package is read by the other: equal, value for value, to the
    writer's own reading of it, and true to the dataset that was written."""
    ds = datasets[which]
    write_pkg, read_pkg = (pyorc_tpu_torch, pyorc_tpu) if writer == "port" else (pyorc_tpu, pyorc_tpu_torch)
    path = tmp_path / f"{which}_{writer}.nc"
    _as_pkg(ds, write_pkg).to_netcdf(path)
    own = write_pkg.open_dataset(path)
    other = read_pkg.open_dataset(path)
    assert isinstance(other, read_pkg.Dataset)
    _hold(other, ds)
    assert set(other.data_vars) == set(own.data_vars) and set(other.coords) == set(own.coords)
    for name in [*own.data_vars, *own.coords]:
        assert other[name].dims == own[name].dims
        np.testing.assert_array_equal(np.asarray(other[name].values), np.asarray(own[name].values), err_msg=name)
    assert other.encoding == own.encoding


def test_both_packages_write_the_same_file_contents(datasets, tmp_path):
    """The same dataset written by each package: the same packed arrays and attributes on disk."""
    import h5py

    ds = datasets["piv"]
    paths = {}
    for name, pkg in (("port", pyorc_tpu_torch), ("jax", pyorc_tpu)):
        paths[name] = tmp_path / f"{name}.nc"
        _as_pkg(ds, pkg).to_netcdf(paths[name])
    with h5py.File(paths["port"], "r") as a, h5py.File(paths["jax"], "r") as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for key in a.keys():
            assert a[key].dtype == b[key].dtype and a[key].compression == b[key].compression, key
            np.testing.assert_array_equal(a[key][()], b[key][()], err_msg=key)
            plain = lambda attrs: {k: np.asarray(v).tolist() for k, v in attrs.items()
                                   if k not in ("DIMENSION_LIST", "REFERENCE_LIST")}
            assert plain(a[key].attrs) == plain(b[key].attrs), key


def test_without_h5py_the_import_error_shows(datasets, tmp_path, monkeypatch):
    """h5py is imported when a file is read or written, not with the package; where it is
    absent, to_netcdf and open_dataset raise the ImportError as it is."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        datasets["bare"].to_netcdf(tmp_path / "none.nc")
    with pytest.raises(ImportError):
        pyorc_tpu_torch.open_dataset(tmp_path / "none.nc")
    assert not (tmp_path / "none.nc").exists()
