"""The port's water-level scorer against the JAX package's on the CPU.

``pyorc_tpu_torch.ops.waterlevel.polygon_histogram_scores`` and its JAX twin
score the same candidate polygon pairs of the Geul fixture
(``tests/test_cross_section.py``: 32 candidates of the far bank) on a random
frame and on the synthetic scene, at bin sizes 5 and 20. Both cast the
even-odd ray at pixel centres in float32, so the per-polygon histogram counts
and pixel totals must be equal, and the scores with them. Edge cases: a
polygon past the frame's edge, a ring of fewer than 3 vertices, the
``min_samples`` gate, and the slot batch (one slot at a time against all).
"""

import numpy as np
import pytest
import torch

import pyorc_tpu
import pyorc_tpu_torch
from pyorc_tpu.ops import waterlevel as jwl
from pyorc_tpu_torch.ops import waterlevel as twl

import chip_smoke

N_CANDIDATES = 32


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def geul():
    """(JAX CrossSection, the port's CrossSection) of the Geul fixture."""
    cc_t = chip_smoke.geul_camera_config()
    cs_t = chip_smoke.geul_cross_section(cc_t)
    cc_j = pyorc_tpu.get_camera_config(cc_t.to_json())
    return pyorc_tpu.CrossSection(cc_j, [[x, y, z] for x, y, z in zip(cs_t.x, cs_t.y, cs_t.z)]), cs_t


@pytest.fixture(scope="module")
def polygons(geul):
    """The two polygons of each of N_CANDIDATES far-bank candidates, in camera pixels."""
    cs = geul[0]
    l_range, _ = cs._preprocess_l_range(*cs.get_line_of_interest(bank="far"), ds_max=0.5, dz_max=0.02)
    l_range = l_range[:: max(1, len(l_range) // N_CANDIDATES)][:N_CANDIDATES]
    pols = [
        [np.asarray(cs.get_csl_pol(l=l, padding=pad, length=2.0, camera=True)[0].exterior.coords) for l in l_range]
        for pad in ((0, 0.5), (-0.5, 0))
    ]
    return pols


@pytest.fixture(scope="module")
def images(geul):
    return {
        "random": np.random.default_rng(3).integers(0, 255, size=(1080, 1920), dtype=np.uint8),
        "scene": chip_smoke.waterline_scene(geul[1]),
    }


def _scores_and_counts(monkeypatch, img, pols1, pols2, **kwargs):
    """Both scorers' scores, and their per-slot (counts, totals) as float64 arrays."""
    seen = {"jax": [], "torch": []}
    jax_counts, torch_counts = jwl._counts_jit, twl._counts

    def jax_spy(*args):
        out = jax_counts(*args)
        seen["jax"].append(tuple(np.asarray(o, np.float64) for o in out))
        return out

    def torch_spy(*args):
        out = torch_counts(*args)
        seen["torch"].append(tuple(o.numpy().astype(np.float64) for o in out))
        return out

    monkeypatch.setattr(jwl, "_counts_jit", jax_spy)
    monkeypatch.setattr(twl, "_counts", torch_spy)
    want = jwl.polygon_histogram_scores(img, pols1, pols2, **kwargs)
    got = twl.polygon_histogram_scores(img, pols1, pols2, **kwargs)
    counts = {}
    for name, parts in seen.items():
        counts[name] = tuple(np.concatenate([p[i] for p in parts]) if parts else None for i in (0, 1))
    n = len(counts["torch"][0]) if seen["torch"] else 0
    # the JAX package pads its slots to a multiple of 32 with empty rings
    counts["jax"] = tuple(c[:n] if c is not None else None for c in counts["jax"])
    return got, want, counts


@pytest.mark.parametrize("bin_size", [5, 20])
@pytest.mark.parametrize("image", ["random", "scene"])
def test_counts_and_scores_equal_jax(monkeypatch, polygons, images, image, bin_size):
    """Equal histogram counts, pixel totals and scores on the fixture's candidates."""
    got, want, counts = _scores_and_counts(monkeypatch, images[image], *polygons, bin_size=bin_size)
    np.testing.assert_array_equal(counts["torch"][0], counts["jax"][0])
    np.testing.assert_array_equal(counts["torch"][1], counts["jax"][1])
    assert counts["torch"][1].max() > 1000 and len(counts["torch"][1]) > len(polygons[0])
    np.testing.assert_array_equal(got, want)
    assert got.shape == (len(polygons[0]),) and (got < 2.0).sum() > len(got) // 2


def test_scene_scores_find_the_waterline(geul, images):
    """On the synthetic scene the scores dip where the candidate splits land from water."""
    cs = geul[1]
    l_range, z_range, scores = cs._water_level_score_range(images["scene"])
    best = cs.camera_config.z_to_h(z_range[int(np.argmin(scores))])
    assert abs(best - chip_smoke.GEUL_H) < chip_smoke.GEUL_TOL


def test_edge_cases_equal_jax(monkeypatch, polygons, images):
    """A polygon past the frame's edge (its pixels outside are not counted), a ring of
    fewer than 3 vertices and a sliver under ``min_samples`` (both score 2.0)."""
    img = images["random"]
    big = polygons[0][-1]
    past = big + [1920 - big[:, 0].min() - 40, 0]  # all but 40 px columns past the right edge
    sliver = np.array([[100, 100], [104, 100], [104, 105], [100, 105], [100, 100]])
    pols1 = [past, big[:2], sliver, big]
    got, want, counts = _scores_and_counts(monkeypatch, img, pols1, [polygons[1][-1]] * 4, min_samples=50)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(counts["torch"][0], counts["jax"][0])
    np.testing.assert_array_equal(counts["torch"][1], counts["jax"][1])
    assert got[1] == 2.0 and got[2] == 2.0 and got[0] < 2.0
    totals = counts["torch"][1]  # live slots: past, sliver, big, then the four second polygons
    assert totals[1] < 50 and 50 <= totals[0] < 0.5 * totals[2]
    # a gate above every polygon's size: all 2.0
    got, want, _ = _scores_and_counts(monkeypatch, img, polygons[0][:4], polygons[1][:4], min_samples=10**6)
    np.testing.assert_array_equal(got, want)
    assert (got == 2.0).all()


def test_no_live_polygon(images):
    """Rings that are all off the frame or degenerate give 2.0 without a device call."""
    off = np.array([[-50.0, -50.0], [-10.0, -50.0], [-10.0, -10.0]])
    got = twl.polygon_histogram_scores(images["random"], [off, off[:2]], [off, off])
    want = jwl.polygon_histogram_scores(images["random"], [off, off[:2]], [off, off])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [2.0, 2.0])


def test_one_slot_per_batch_equals_all_at_once(monkeypatch, polygons, images):
    """The slot batch is sized from a byte budget; the counts do not depend on it."""
    img = images["scene"]
    calls = []
    counts = twl._counts

    def spy(*args):
        calls.append(args[2].shape[0])
        return counts(*args)

    monkeypatch.setattr(twl, "_counts", spy)
    all_at_once = twl.polygon_histogram_scores(img, *polygons)
    assert len(calls) == 1
    n_slots = calls.pop()
    monkeypatch.setattr(twl, "BATCH_BYTES", 1)
    one_by_one = twl.polygon_histogram_scores(img, *polygons)
    np.testing.assert_array_equal(one_by_one, all_at_once)
    assert set(calls) == {1} and len(calls) == n_slots > len(polygons[0])


def test_bytes_up(polygons, images):
    """The padded frame goes up once, then only ring-sized arrays."""
    from pyorc_tpu_torch._device import COPY_BYTES

    before = COPY_BYTES["h2d"]
    twl.polygon_histogram_scores(images["random"], *polygons)
    moved = COPY_BYTES["h2d"] - before
    frame = 1080 * 1920
    assert frame < moved < frame * 1.6, moved
