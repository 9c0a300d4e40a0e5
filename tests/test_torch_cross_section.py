"""The port's CrossSection: every case of ``tests/test_cross_section.py`` on the port's
class, and the port against the JAX package on the Geul fixture (the same camera
and bathymetry, the literals copied into ``chip_smoke.py``).

Geometry is host float64 numpy in both packages: every waterline, polygon and
surface must equal JAX's to 1e-9 (relative or absolute). The optical water level
must give JAX's level with s2n within 1e-6 relative (grid scan with s2n), JAX's
level by the grid search, and by differential evolution with ``np.random.seed``
set before each call. ``get_polygon_pixels`` (the port's fill in place of
``cv2.fillPoly``) must return JAX's pixels, and ``Transect.wetted_surface`` and
``wetted_perimeter`` JAX's values.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import pyorc_tpu
import pyorc_tpu_torch
from pyorc_tpu.api import cross_section as jcs
from pyorc_tpu_torch import CrossSection
from pyorc_tpu_torch.api import cross_section as tcs
from pyorc_tpu_torch.geom import shapes

import chip_smoke
import test_cross_section as jax_cases

H_TRUE = chip_smoke.GEUL_H
GEOM_TOL = 1e-9


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def camera_config():
    return chip_smoke.geul_camera_config()


@pytest.fixture(scope="module")
def cs(camera_config):
    return chip_smoke.geul_cross_section(camera_config)


@pytest.fixture(scope="module")
def cs_jax(cs):
    cc = pyorc_tpu.get_camera_config(cs.camera_config.to_json())
    return pyorc_tpu.CrossSection(cc, [[x, y, z] for x, y, z in zip(cs.x, cs.y, cs.z)])


@pytest.fixture(scope="module")
def synth_img(cs):
    return chip_smoke.waterline_scene(cs)


def _arr(g):
    """Nested coordinate arrays of a geometry, a multi-geometry or a list of them."""
    if isinstance(g, (list, tuple)):
        return [_arr(x) for x in g]
    if hasattr(g, "geoms"):
        return [_arr(x) for x in g.geoms]
    return np.asarray(getattr(g, "_coords", g), dtype=np.float64)


def _hold(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _hold(a, b)
        return
    assert np.shape(got) == np.shape(want)
    np.testing.assert_allclose(got, want, rtol=GEOM_TOL, atol=GEOM_TOL)


def test_the_smoke_fixture_is_the_test_fixture(cs, cs_jax, synth_img):
    """chip_smoke's copy of the Geul literals is tests/test_cross_section.py's, and its
    scene is that file's ``synth_img`` (cv2.fillPoly there, the port's fill here)."""
    assert chip_smoke.GEUL_ZS == jax_cases.ZS
    assert chip_smoke.GEUL_LON == jax_cases.XS_LON and chip_smoke.GEUL_LAT == jax_cases.YS_LAT
    assert chip_smoke.GEUL_H == jax_cases.H_TRUE_SYNTH
    want_cc = jax_cases.camera_config.__wrapped__()
    assert json.loads(cs.camera_config.to_json()) == json.loads(want_cc.to_json())
    np.testing.assert_array_equal(synth_img, jax_cases.synth_img.__wrapped__(cs_jax))


# -- the cases of tests/test_cross_section.py on the port's class ------------------------


def test_init(cs):
    assert isinstance(cs, CrossSection)
    assert len(cs.x) == 24
    assert cs.s[0] == 0
    assert np.all(np.diff(cs.s) >= 0)
    assert np.all(np.diff(cs.l) >= 0)
    assert isinstance(str(cs), str)


def test_within_image(cs):
    assert cs.within_image


def test_get_bbox(cs):
    z = min(cs.z[0], cs.z[-1]) - 0.05
    bbox = cs.get_bbox(h=cs.camera_config.z_to_h(z))
    assert isinstance(bbox, shapes.Polygon)
    assert not bbox.has_z
    assert bbox.area > 0


def test_get_cs_waterlevel(cs):
    line = cs.get_cs_waterlevel(h=93.0)
    assert isinstance(line, shapes.LineString) and line.has_z
    assert np.isclose(cs.get_cs_waterlevel(h=93.0, extend_by=0.2).length - line.length, 0.4)
    line_sz = cs.get_cs_waterlevel(h=93.0, sz=True)
    assert not line_sz.has_z
    assert np.isclose(cs.get_cs_waterlevel(h=93.0, sz=True, extend_by=0.2).length - line_sz.length, 0.4)


def test_get_csl_point(cs):
    for h in (92.5, 93.0):
        p = cs.get_csl_point(h=h)
        assert len(p) == 2 and p[0].has_z
        p_cam = cs.get_csl_point(h=h, camera=True)
        assert len(p_cam) == 2 and not p_cam[0].has_z
    assert len(cs.get_csl_point(l=5.0)) == 1
    assert len(cs.get_csl_point(l=8.0)) == 1


def test_get_csl_point_errors(cs):
    with pytest.raises(ValueError, match="One of h or l"):
        cs.get_csl_point()
    with pytest.raises(ValueError, match="Only one of h or l"):
        cs.get_csl_point(h=93.0, l=5.0)


def test_get_csl_line(cs):
    assert len(cs.get_csl_line(h=92.5, offset=0.0, length=4)) == 2
    assert len(cs.get_csl_line(h=93.0, offset=0.0, length=4)) == 2
    assert len(cs.get_csl_line(l=5.0, offset=0.0, length=4)) == 1
    assert len(cs.get_csl_line(h=92.5, offset=2.0, camera=True)) == 2
    assert len(cs.get_csl_line(h=94.9)) == 1  # above one bank: one crossing


def test_get_csl_pol(cs):
    pol1 = cs.get_csl_pol(h=93.25, offset=0.0, padding=(-2, 0), length=4.0)
    pol2 = cs.get_csl_pol(h=93.25, offset=0.0, padding=(0, 2), length=4.0)
    assert all(isinstance(p, shapes.Polygon) for p in pol1 + pol2)
    assert all(isinstance(p, shapes.Polygon) for p in cs.get_csl_pol(h=93.25, padding=(-1, 1), camera=True))
    with pytest.raises(ValueError, match="padding"):
        cs.get_csl_pol(h=93.25, padding=(1, -1))


def test_get_planar_surface(cs):
    pol = cs.get_planar_surface(h=93.0, length=2.0)
    assert isinstance(pol, (shapes.Polygon, shapes.MultiPolygon))
    area = pol.area if isinstance(pol, shapes.Polygon) else sum(p.area for p in pol.geoms)
    assert area > 0


def test_get_bottom_surface(cs):
    pol = cs.get_bottom_surface(length=2.0)
    assert isinstance(pol, shapes.Polygon) and pol.area > 0
    assert isinstance(cs.get_bottom_surface(length=2.0, camera=True), shapes.Polygon)


def test_get_wetted_surface_sz(cs):
    pols = cs.get_wetted_surface_sz(h=93.0)
    assert isinstance(pols, shapes.MultiPolygon) and pols.area > 0
    assert cs.get_wetted_surface_sz(h=93.5).area > pols.area
    perim = cs.get_wetted_surface_sz(h=93.0, perimeter=True)
    assert isinstance(perim, shapes.MultiLineString)
    assert perim.length > 0.5 * cs.get_cs_waterlevel(h=93.0, sz=True).length


def test_get_wetted_surface(cs):
    assert isinstance(cs.get_wetted_surface(h=93.0), shapes.MultiPolygon)
    assert isinstance(cs.get_wetted_surface(h=93.0, camera=True), shapes.MultiPolygon)


def test_get_bbox_dry_wet(cs):
    bbox_wet = cs.get_bbox_dry_wet(h=93.0)
    bbox_dry = cs.get_bbox_dry_wet(h=93.0, dry=True)
    assert isinstance(bbox_wet, shapes.MultiPolygon) and isinstance(bbox_dry, shapes.MultiPolygon)
    assert len(bbox_wet.geoms) == 1 and len(bbox_dry.geoms) == 2
    assert bbox_wet.has_z
    assert isinstance(cs.get_bbox_dry_wet(h=93.0, camera=True), shapes.MultiPolygon)


def test_rotate_translate_linearize(cs):
    cs2 = cs.rotate_translate(angle=0.1, xoff=1.0, yoff=-1.0, zoff=0.5)
    assert isinstance(cs2, CrossSection)
    assert np.isclose(cs2.z[0], cs.z[0] + 0.5)
    coords = np.column_stack([cs.linearize().x, cs.linearize().y])
    _, sv, _ = np.linalg.svd(coords - coords.mean(axis=0))
    assert sv[1] < 1e-8


def test_line_of_interest(cs):
    l_both = cs.get_line_of_interest(bank="both")
    assert np.isclose(l_both[0], cs.l.min()) and np.isclose(l_both[1], cs.l.max())
    for bank in ("far", "near"):
        lo, hi = cs.get_line_of_interest(bank=bank)
        assert lo < hi
    with pytest.raises(ValueError):
        cs.get_line_of_interest(bank="bogus")


def test_water_level_detection_synthetic(cs, synth_img):
    h_det, s2n = cs.detect_water_level_s2n(synth_img, bank="far", length=2.0, padding=0.5)
    assert s2n > chip_smoke.GEUL_S2N_MIN
    assert abs(h_det - H_TRUE) < chip_smoke.GEUL_TOL, f"detected {h_det} vs true {H_TRUE}"


def test_detect_water_level_min_h(cs, synth_img):
    min_h = H_TRUE + 0.5
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the optimum may sit at the bound
        h = cs.detect_water_level(synth_img, bank="far", length=2.0, min_h=min_h)
    assert isinstance(h, float) and h >= min_h - 1e-6


def test_detect_water_level_banks(cs, synth_img):
    for bank in ("near", "both"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # edge of the range is data-dependent
            h = cs.detect_water_level(synth_img, bank=bank, length=2.0)
        assert cs.z.min() - 1 < cs.camera_config.h_to_z(h) < cs.z.max() + 1


def test_get_csl_line_above_first_bank(cs):
    assert len(cs.get_csl_line(h=94.9)) == 1


def test_detect_water_level_de(cs):
    """As tests/test_cross_section.py's case of this name (which runs the default method,
    the grid search): on a random frame the level stays in range."""
    img = np.random.default_rng(5).integers(0, 255, size=(1080, 1920), dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        h = cs.detect_water_level(img, bank="far")
    assert cs.z.min() - 1 < cs.camera_config.h_to_z(h) < cs.z.max() + 1


def test_plot_methods(cs, camera_config):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h = camera_config.z_to_h(np.percentile(cs.z, 40))
    for name, kw in [
        ("plot", {"h": h}), ("plot", {"camera": True}),
        ("plot_cs", {}), ("plot_cs", {"camera": True}),
        ("plot_planar_surface", {"h": h}), ("plot_planar_surface", {"h": h, "camera": True}),
        ("plot_bottom_surface", {}), ("plot_bottom_surface", {"camera": True}),
        ("plot_wetted_surface", {"h": h}), ("plot_wetted_surface", {"h": h, "camera": True}),
        ("plot_bbox_dry_wet", {"h": h}), ("plot_bbox_dry_wet", {"h": h, "camera": True}),
        ("plot_water_level", {"h": h}), ("plot_water_level", {"h": h, "camera": True}),
    ]:
        assert getattr(cs, name)(**kw) is not None, name
    plt.close("all")


def test_batched_water_level_scores_match_host(cs):
    """The device-batched scorer tracks the per-candidate host path (the same optimum,
    scores within rasterization tolerance), as tests/test_cross_section.py holds JAX's."""
    img = np.random.default_rng(3).integers(0, 255, size=(1080, 1920), dtype=np.uint8)
    l_range, _ = cs._preprocess_l_range(*cs.get_line_of_interest(bank="far"), ds_max=0.5, dz_max=0.02)
    l_range = l_range[::4]
    host = np.array([cs.get_histogram_score(x=[l], img=img, bin_size=5, padding=0.5, length=2.0) for l in l_range])
    batched = cs._scores_batched(img, l_range, bin_size=5, padding=0.5, length=2.0)
    both = (host < 1.99) & (batched < 1.99)
    assert both.mean() > 0.5
    assert np.abs(host[both] - batched[both]).max() < 0.08
    assert abs(int(np.argmin(host)) - int(np.argmin(batched))) <= 1


def test_image_shape_is_checked(cs):
    """The JAX package checks the frame's shape with ``assert``; the port raises ``ValueError``."""
    small = np.zeros((540, 960), np.uint8)
    with pytest.raises(ValueError, match="height"):
        cs.detect_water_level_s2n(small)
    with pytest.raises(ValueError, match="width"):
        cs.detect_water_level(np.zeros((1080, 960), np.uint8))


# -- the port against the JAX package ------------------------------------------------------


GEOMETRY = {
    "coords": lambda c: [np.column_stack([c.x, c.y, c.z, c.s, c.l, c.d])],
    "cs_waterlevel": lambda c: c.get_cs_waterlevel(h=93.0, extend_by=0.2),
    "cs_waterlevel_sz": lambda c: c.get_cs_waterlevel(h=93.0, sz=True, extend_by=0.2),
    "csl_point": lambda c: c.get_csl_point(h=92.5),
    "csl_point_l_camera": lambda c: c.get_csl_point(l=5.0, camera=True, swap_y_coords=True),
    "csl_line": lambda c: c.get_csl_line(h=92.5, offset=2.0, length=4),
    "csl_line_camera": lambda c: c.get_csl_line(h=92.5, offset=2.0, camera=True),
    "csl_pol": lambda c: c.get_csl_pol(h=93.25, padding=(-2, 0), length=4.0),
    "csl_pol_camera": lambda c: c.get_csl_pol(l=6.0, padding=(-0.5, 0), camera=True),
    "bbox": lambda c: c.get_bbox(h=c.camera_config.z_to_h(min(c.z[0], c.z[-1]) - 0.05)),
    "planar_surface": lambda c: c.get_planar_surface(h=93.0),
    "planar_surface_camera": lambda c: c.get_planar_surface(h=93.0, camera=True),
    "bottom_surface": lambda c: c.get_bottom_surface(length=2.0, offset=0.5),
    "bottom_surface_camera": lambda c: c.get_bottom_surface(camera=True),
    "wetted_surface_sz": lambda c: c.get_wetted_surface_sz(h=93.0),
    "wetted_perimeter_sz": lambda c: c.get_wetted_surface_sz(h=93.5, perimeter=True),
    "wetted_surface": lambda c: c.get_wetted_surface(h=93.0),
    "wetted_surface_camera": lambda c: c.get_wetted_surface(h=93.0, camera=True),
    "bbox_wet": lambda c: c.get_bbox_dry_wet(h=93.0),
    "bbox_dry_camera": lambda c: c.get_bbox_dry_wet(h=93.0, dry=True, camera=True),
    "rotate_translate": lambda c: [np.column_stack([r.x, r.y, r.z, r.s]) for r in [c.rotate_translate(0.1, 1.0, -1.0, 0.5)]],
    "linearize": lambda c: [np.column_stack([r.x, r.y, r.z, r.l]) for r in [c.linearize()]],
    "line_of_interest": lambda c: [np.asarray([c.get_line_of_interest(b) for b in ("far", "near", "both")])],
    "l_range": lambda c: [np.column_stack(c._preprocess_l_range(*c.get_line_of_interest("far")))],
    "scalars": lambda c: [np.asarray([c.cs_angle, c.distance_camera, c.idx_closest_point, c.idx_farthest_point])],
}


@pytest.mark.parametrize("case", GEOMETRY)
def test_geometry_equals_jax(cs, cs_jax, case):
    """Every geometry getter gives JAX's coordinates to 1e-9."""
    _hold(_arr(GEOMETRY[case](cs)), _arr(GEOMETRY[case](cs_jax)))


def test_detect_water_level_s2n_equals_jax(cs, cs_jax, synth_img):
    """The grid scan with s2n, at a coarse ``dz_max``: JAX's level, s2n within 1e-6 relative."""
    got = cs.detect_water_level_s2n(synth_img, dz_max=0.1, ds_max=1.0)
    want = cs_jax.detect_water_level_s2n(synth_img, dz_max=0.1, ds_max=1.0)
    assert got[0] == want[0]
    assert abs(got[1] - want[1]) <= 1e-6 * abs(want[1])
    assert abs(got[0] - H_TRUE) < chip_smoke.GEUL_TOL and got[1] > chip_smoke.GEUL_S2N_MIN


def test_detect_water_level_grid_equals_jax(cs, cs_jax, synth_img):
    """The grid search, its scored candidates cut to those between ``min_h`` and ``max_h``
    (the rest take the penalty without a polygon): JAX's level."""
    kwargs = {"method": "grid", "min_h": H_TRUE - 0.3, "max_h": H_TRUE + 0.3}
    got, want = cs.detect_water_level(synth_img, **kwargs), cs_jax.detect_water_level(synth_img, **kwargs)
    assert got == want and abs(got - H_TRUE) < chip_smoke.GEUL_TOL


def test_detect_water_level_de_equals_jax(cs, cs_jax, synth_img):
    """Differential evolution on the per-candidate host path (the port's fill, JAX's
    cv2.fillPoly): with the same seed the same sequence of scores and the same level."""
    kwargs = {"method": "de", "min_h": H_TRUE - 0.3, "max_h": H_TRUE + 0.3}
    out = []
    for c in (cs, cs_jax):
        np.random.seed(1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            out.append(c.detect_water_level(synth_img, **kwargs))
    assert out[0] == out[1]
    assert abs(out[0] - H_TRUE) < chip_smoke.GEUL_TOL


def test_get_polygon_pixels_equals_jax(cs, cs_jax, synth_img):
    """The port's fill gives JAX's cv2.fillPoly pixels: candidate polygons of the fixture,
    random polygons, and polygons past the frame's edges."""
    rng = np.random.default_rng(11)
    pols = [p for l in (2.0, 4.5, 7.0) for p in cs.get_csl_pol(l=l, padding=(-0.5, 0.5), camera=True)]
    rings = [np.asarray(p.exterior.coords) for p in pols]
    for _ in range(12):
        centre = rng.uniform([-100, -100], [2020, 1180])
        angles = np.sort(rng.uniform(0, 2 * np.pi, rng.integers(3, 12)))
        radii = rng.uniform(5, 300, len(angles))
        rings.append(centre + np.column_stack([radii * np.cos(angles), radii * np.sin(angles)]))
    rings.append(rings[-1][:2])  # fewer than 3 vertices
    for ring in rings:
        got = tcs.get_polygon_pixels(synth_img, shapes.Polygon(ring))
        want = jcs.get_polygon_pixels(synth_img, pyorc_tpu.geom.shapes.Polygon(ring))
        np.testing.assert_array_equal(got, want)


def test_transect_wetted_surface_equals_jax():
    """``Transect.cross_section`` now builds the port's CrossSection: wetted surface and
    perimeter of the smoke chain's transect equal JAX's."""
    h, w = 240, 320
    cc = chip_smoke.nadir_camera_config(h, w, gcp_px=30, aoi_px=40)
    cc_j = pyorc_tpu.get_camera_config(cc.to_json())
    stack = chip_smoke.advected_stack(h, w, 4, "cpu")
    out = []
    for pkg, c in ((pyorc_tpu_torch, cc), (pyorc_tpu, cc_j)):
        proj = chip_smoke.frames_dataarray(stack, c, pkg=pkg).frames.project()
        piv = proj.frames.get_piv(window_size=32)
        tr = piv.velocimetry.get_transect(*chip_smoke.transect_points(c, margin_px=16, aoi_px=40))
        out.append(tr.transect)
    assert isinstance(out[0].cross_section, CrossSection)
    assert out[0].wetted_surface > 0 and out[0].wetted_perimeter > 0
    assert abs(out[0].wetted_surface - out[1].wetted_surface) <= GEOM_TOL * out[1].wetted_surface
    assert abs(out[0].wetted_perimeter - out[1].wetted_perimeter) <= GEOM_TOL * out[1].wetted_perimeter
