"""The route gives the projected grid the kernels' work is counted on, and the chain takes its cross-section from
its caller: the nadir configurations keep their bounds and outputs, and a route off the nadir geometry (no
``camera``, a grid that is no ``(h - 2a, w - 2a)``) runs through ``run_cell`` and its readers. A route without
``grid_shape`` is refused with the others that lack a part of the contract (``test_harness_data_driven.py``)."""

import json
import shutil

import numpy as np
import pytest

from toy import BENCH, add_cell, copy_bench, toy_cell

# work.video_bounds of each configuration at its cells' frames a video, as the harness counted them while it
# took the grid from the nadir camera's aoi_px
PARENT_BOUNDS = {
    "nadir_4k_ens64": {1800: {"piv_ensemble": 36.710027080597015}},
    "ngwerere_1080p_mp26": {126: {"piv_pairs": 2.6929133090480555, "deform_pairs": 1.3598476417910448}},
}


@pytest.mark.parametrize("config", sorted(PARENT_BOUNDS))
def test_video_bounds_are_the_parents(config):
    import run
    import work

    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    grid = run.load_route(BENCH, cfg).grid_shape(cfg)
    for n_frames, want in PARENT_BOUNDS[config].items():
        assert work.video_bounds(cfg, n_frames, grid) == want


def test_a_route_off_the_nadir_geometry(tmp_path):
    import run
    import work

    import pyorc_tpu_torch

    copy_bench(tmp_path)
    shutil.copy(BENCH / "tests" / "inset_route.py", tmp_path / "benchmark" / "routes" / "inset.py")
    cfg = json.loads((BENCH / "configs" / "ngwerere_1080p_mp26.json").read_text())
    del cfg["camera"]
    cfg.update(name="toy_inset", route="inset", height=120, width=200,
               view={"f": 200.0, "gcp_px": 8, "inset_rows": 10, "inset_cols": 18},
               transect={"n_points": 11, "margin_px": 12})
    cfg["piv"].update(window_size=8, overlap=[4, 4])
    (tmp_path / "benchmark" / "workloads" / "toy_inset.json").write_text(
        json.dumps({"frames_per_video": 8, "ring_frames": 16}))
    name = add_cell(tmp_path, cfg, "toy_inset", per_layer=("piv_pairs_roofline", "deform_roofline"))

    cell = run.load_cell(tmp_path, name)
    grid = cell["route"].grid_shape(cell["cfg"])
    assert "camera" not in cell["cfg"] and grid == (100, 164)
    assert all(grid != (120 - 2 * a, 200 - 2 * a) for a in range(60))
    readers = {m["name"] for m in cell["per_layer"]}
    assert {"mfu.video", "piv_pairs_roofline", "deform_roofline"} <= readers

    pyorc_tpu_torch.set_device("cpu")
    out = run.run_cell(cell, 2**31 + 19, 0.0, True, "cpu", min_passes=1)
    result = out["result"]
    assert result["correct"], out["numbers"]
    assert out["numbers"]["frames_gap"] == 0  # the program's projected frames are the grid's shape
    assert out["info"]["videos"] == 2
    # every reader ran on the grid; a roofline finds no kernel on the CPU and leaves its metric out
    assert readers - {"piv_pairs_roofline", "deform_roofline"} <= set(result["metrics"])
    bound_ms = work.video_bounds(cell["cfg"], 8, grid)
    want = 100.0 * result["attempted"] * sum(bound_ms.values()) / 1e3 / result["device"]["window_s"]
    assert result["metrics"]["mfu.video"]["value"] == pytest.approx(want, rel=1e-12)
    assert sum(bound_ms.values()) > sum(work.video_bounds(cell["cfg"], 8, (100, 100)).values())


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k], equal_nan=True) for k in a)


def test_the_chain_takes_its_cross_section_from_its_caller():
    import chain
    import traffic

    import pyorc_tpu_torch

    pyorc_tpu_torch.set_device("cpu")
    cell = toy_cell("ngwerere_1080p_mp26.video126")
    cfg, route = cell["cfg"], cell["route"]
    videos = route.make_videos(cfg, cell["traffic"], 2**31 + 23, "cpu")
    cc = route.setup(cfg)

    def chain_over(points):
        frames = lambda: chain.frames_dataarray(videos.source(0), cc, cfg["fps"])  # noqa: E731
        return route.video_answers(chain.run_chain(frames, cfg, points, (1, 5)))

    nadir = route.video_answers(route.run_video(videos.source(0), cc, cfg, (1, 5)))
    assert _same(nadir, chain_over(traffic.transect_points(cfg)))
    x, y, z = traffic.transect_points(cfg)
    moved = chain_over((x - 0.2, y, z))
    assert _same({k: v for k, v in moved.items() if k not in ("v_eff", "river_flow")},
                 {k: v for k, v in nadir.items() if k not in ("v_eff", "river_flow")})
    assert not np.array_equal(moved["v_eff"], nadir["v_eff"])
    # the nadir route's reference across the same points agrees with the chain's cross-section
    ref = route.reference_video(videos.frames(0), cfg)
    assert np.nanmax(np.abs(nadir["v_eff"] - ref["v_eff"])) <= cfg["limits"]["transect_gap"]


def test_only_the_nadir_routes_files_read_its_camera():
    """``camera`` and ``aoi_px`` are the nadir route's (``routes/nadir_piv.py``, ``traffic.py``,
    ``chain.camera_config``): the harness, its readers, control and faults and the plain reference, which the
    route hands its camera's view, name neither."""
    import ast

    files = [BENCH / f"{name}.py" for name in ("run", "work", "control", "faults", "readings", "roofline", "devtrace")]
    for path in files + sorted((BENCH / "metrics").glob("*.py")) + sorted((BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            assert not (isinstance(node, ast.Constant) and node.value in ("camera", "aoi_px")), path.name
