"""The port's ``get_transect`` against the JAX package's, bit for bit, on seeded fields.

The port computes the window median (``stack_window`` -> the tolerance count
-> the median over the strides) on the grid cells the sample points'
bilinear stencils read; JAX computes it on the whole stacked field. Every
quantile, ``v_dir`` and ``v_eff_nofill`` must be equal, NaN in the same
places: NaN holes and whole NaN columns, points on the grid's first and last
rows and columns and outside it, ascending and descending y, ``wdw`` 0, 1 and
2 with asymmetric windows, ``tolerance`` 0.1 and 0.9, ``rolling=3``.
"""

import numpy as np
import pytest

import pyorc_tpu
import pyorc_tpu_torch
from pyorc_tpu_torch import helpers as thelpers
from pyorc_tpu_torch import ndx as tndx

NT, NY, NX = 7, 23, 31
RES = 0.5
VARS = ("v_x", "v_y", "s2n", "corr")


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")


def seeded_fields(seed):
    """float32 [time, y, x] fields with random NaN holes, a whole NaN column and a NaN row band."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, scale in zip(VARS, (1.0, 1.0, 5.0, 0.5)):
        a = (rng.standard_normal((NT, NY, NX)) * scale).astype(np.float32)
        a[rng.random(a.shape) < 0.25] = np.nan
        a[:, :, 4] = np.nan
        a[:, :, NX - 2] = np.nan
        a[: NT - 1, 9:11, :] = np.nan
        out[k] = a
    return out


def grid(descending):
    x = RES / 2 + RES * np.arange(NX)
    y = RES / 2 + RES * np.arange(NY)
    return x, (y[::-1].copy() if descending else y)


def dataset(pkg, fields, descending):
    x, y = grid(descending)
    xs, ys = np.meshgrid(x, y)
    return pkg.ndx.Dataset(
        {k: (("time", "y", "x"), v.copy(), {"units": "m s-1"}) for k, v in fields.items()},
        coords={"time": np.arange(NT) * 0.16, "y": y, "x": x, "xs": (("y", "x"), xs), "ys": (("y", "x"), ys)},
        attrs={"note": "seeded"},
    )


def sample_points(descending):
    """A diagonal line from the grid's first row and column to its last, two points past its
    edges, and points on the first and last rows and columns."""
    x, y = grid(descending)
    lo_y, hi_y = min(y), max(y)
    t = np.linspace(0.0, 1.0, 17)
    px = list(x[0] + t * (x[-1] - x[0])) + [x[0] - 1.3, x[-1] + 0.7, x[0], x[-1], x[7], x[12]]
    py = list(lo_y + t * (hi_y - lo_y)) + [y[3], y[5], y[8], y[2], lo_y, hi_y]
    pz = -np.linspace(0.1, 1.0, len(px))
    s = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(px), np.diff(py)))])
    return np.asarray(px), np.asarray(py), pz, s


CASES = {
    "wdw1": dict(wdw=1),
    "wdw2": dict(wdw=2),
    "wdw0": dict(wdw=0),
    "wdw1-asym": dict(wdw=1, wdw_x_min=-2, wdw_x_max=0, wdw_y_min=-1, wdw_y_max=2),
    "wdw2-asym": dict(wdw=2, wdw_x_min=0, wdw_x_max=1, wdw_y_min=-3, wdw_y_max=1),
    "tol0.1": dict(wdw=1, tolerance=0.1),
    "tol0.9": dict(wdw=2, tolerance=0.9),
    "rolling3": dict(wdw=1, rolling=3),
}


def transects(kwargs, descending, seed=0, resample=False):
    fields = seeded_fields(seed)
    px, py, pz, s = sample_points(descending)
    extra = {} if resample else {"s": s}
    got = dataset(pyorc_tpu_torch, fields, descending).velocimetry.get_transect(px, py, pz, **extra, **kwargs)
    want = dataset(pyorc_tpu, fields, descending).velocimetry.get_transect(px, py, pz, **extra, **kwargs)
    return got, want


def assert_same(got, want):
    assert list(got.data_vars) == list(want.data_vars)
    assert list(got.coords) == list(want.coords)
    for name in list(want.data_vars) + list(want.coords):
        a, b = np.asarray(want[name].values), np.asarray(got[name].values)
        assert tuple(got[name].dims) == tuple(want[name].dims), name
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)  # NaN must sit in the same places
    for name in want.data_vars:
        assert got[name].attrs == want[name].attrs, name


@pytest.mark.parametrize("descending", [True, False], ids=["y-descending", "y-ascending"])
@pytest.mark.parametrize("case", list(CASES))
def test_transect_equals_jax(case, descending):
    got, want = transects(CASES[case], descending, seed=len(case))
    assert np.isfinite(want["v_x"].values).any() and np.isnan(want["v_x"].values).any()
    assert_same(got, want)


def test_transect_resampled_line_equals_jax():
    """Without ``s``: the line is resampled at the grid's spacing first."""
    got, want = transects(dict(wdw=1), True, seed=5, resample=True)
    assert_same(got, want)


def test_median_runs_on_the_stencil_cells_only(monkeypatch):
    """The window median is taken on the cells the stencils read, never on the whole stacked field."""
    seen, stencils = [], []

    def recorded(ds, cells, **kw):
        seen.append({d: np.asarray(i).copy() for d, i in cells.items()})
        return stack_window_cells(ds, cells, **kw)

    def recorded_cells(self, **targets):
        out = interp_cells(self, **targets)
        stencils.append(({d: t.values.copy() for d, t in targets.items()}, out))
        return out

    def whole_field(*args, **kwargs):
        raise AssertionError("get_transect stacked the whole field")

    stack_window_cells = thelpers.stack_window_cells
    interp_cells = tndx.DataArray.interp_cells
    monkeypatch.setattr(thelpers, "stack_window_cells", recorded)
    monkeypatch.setattr(thelpers, "stack_window", whole_field)
    monkeypatch.setattr(tndx.DataArray, "interp_cells", recorded_cells)
    px, py, pz, s = sample_points(True)
    ds = dataset(pyorc_tpu_torch, seeded_fields(1), True)
    ds.velocimetry.get_transect(px, py, pz, s=s, wdw=2)
    (cells,), ((targets, stencil),) = seen, stencils
    n_cells = len(cells["y"])
    assert 0 < n_cells <= 4 * len(px) < NY * NX
    assert len(np.unique(cells["y"] * NX + cells["x"])) == n_cells  # each cell once
    for d in ("y", "x"):
        np.testing.assert_array_equal(cells[d], stencil[d])
    x = grid(True)[0]
    assert ((targets["x"] < x[0]) | (targets["x"] > x[-1])).sum() == 2  # two points outside the grid read no cell


def test_interp_cells_are_what_interp_reads():
    """Poisoning every other cell leaves pointwise ``interp`` unchanged; poisoning any one of them changes it."""
    rng = np.random.default_rng(4)
    x, y = grid(True)
    data = rng.standard_normal((3, NY, NX))
    da = tndx.DataArray(data, dims=("time", "y", "x"), coords={"y": y, "x": x})
    px = np.concatenate([rng.uniform(x[0] - 1, x[-1] + 1, 40), [x[0], x[-1], x[5]]])
    py = np.concatenate([rng.uniform(y[-1] - 1, y[0] + 1, 40), [y[0], y[-1], y[-1]]])
    _x = tndx.DataArray(px, dims=("points",))
    _y = tndx.DataArray(py, dims=("points",))
    want = da.interp(x=_x, y=_y).values
    cells = da.interp_cells(x=_x, y=_y)
    keep = np.zeros((NY, NX), bool)
    keep[cells["y"], cells["x"]] = True
    poisoned = tndx.DataArray(np.where(keep, data, np.nan), dims=("time", "y", "x"), coords={"y": y, "x": x})
    np.testing.assert_array_equal(poisoned.interp(x=_x, y=_y).values, want)
    for iy, ix in list(zip(cells["y"], cells["x"]))[:: max(1, len(cells["y"]) // 12)]:
        one = data.copy()
        one[:, iy, ix] = np.nan
        got = tndx.DataArray(one, dims=("time", "y", "x"), coords={"y": y, "x": x}).interp(x=_x, y=_y).values
        assert np.isnan(got).sum() > np.isnan(want).sum()


def test_chip_smoke_host_stages_step_on_cpu():
    """``chip_smoke.host_stages_phase`` (step 4b) at a small size: maps of an oblique and a nadir
    camera as tensor ops on the CPU against the host, and the transect both ways on a 16 px PIV."""
    import chip_smoke
    from test_torch_ortho_filters import AOIS, oblique_camera_config

    h, w = 240, 320
    cc = chip_smoke.nadir_camera_config(h, w, aoi_px=40)
    stack = chip_smoke.advected_stack(h, w, 5, "cpu")
    proj = chip_smoke.frames_dataarray(stack, cc).frames.normalize(samples=5).frames.project()
    pivs = {16: proj.frames.get_piv(window_size=16, overlap=(8, 8))}
    cameras = {
        "oblique": (pyorc_tpu_torch.get_camera_config(oblique_camera_config(*AOIS[2]).to_json()), 0.0),
        "nadir": (cc, chip_smoke.H_A),
    }
    out = chip_smoke.host_stages_phase(pivs, cc, "cpu", cameras=cameras, aoi_px=40)
    assert out["maps"]["oblique"]["mean_groups"] > 0 and out["maps"]["nadir"]["separable"]
    assert out["host_blas_rule"] in ("fma", "plain")
    assert out["transect"][16]["finite_v_x"] > 0
