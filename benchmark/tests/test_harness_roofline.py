"""The benchmark's frozen bounds equal the port's ``ops/roofline.py`` formulas at the cells' shapes today."""

import json

import pytest
import torch

from toy import CELLS, ROOT


@pytest.mark.parametrize("name", CELLS)
def test_frozen_bounds_equal_the_ports(name):
    import roofline as frozen
    import run
    import work
    from pyorc_tpu_torch.ops import roofline as port

    cell = run.load_cell(ROOT, name)
    cfg = cell["cfg"]
    n = json.loads((ROOT / "benchmark" / "workloads" / f"{name.split('.')[1]}.json").read_text())["frames_per_video"]
    h, w = cell["route"].grid_shape(cfg)
    meta = dict(device="meta")
    bounds = work.video_bounds(cfg, n, (h, w))
    assert bounds and all(b > 0 for b in bounds.values())
    for fn in ("work_bound", "pairs_bound", "ensemble_bound", "deform_bound"):
        assert hasattr(frozen, fn)
    assert (frozen.PEAK_FP32_FLOPS, frozen.PEAK_HBM_BYTES, frozen.DEFORM_PEAK_FLOPS) == (
        port.PEAK_FP32_FLOPS, port.PEAK_HBM_BYTES, port.DEFORM_PEAK_FLOPS)
    ws = cfg["piv"]["window_size"] + cfg["piv"]["window_size"] % 2
    if cfg["piv"]["ensemble_corr"]:
        ov = tuple(cfg["piv"]["overlap"])
        args = ((h, w), (ws, ws), ov, (h - ws) // (ws - ov[0]) + 1, (w - ws) // (ws - ov[1]) + 1)
        frames = torch.empty((n, h, w), dtype=torch.uint8, **meta)
        assert frozen.ensemble_bound(frames, args) == port.ensemble_bound(frames, args)
        assert bounds["piv_ensemble"] == port.ensemble_bound(frames, args)[0]
        return
    pairs = torch.empty((2 * (n - 1), h, w), dtype=torch.float32, **meta)
    stack = torch.empty((n, h, w), dtype=torch.uint8, **meta)
    frames = torch.empty((n, h, w), dtype=torch.float32, **meta)
    total, deform, prev = 0.0, 0.0, None
    for k in range(cfg["piv"]["passes"]):
        size = ws * 2 ** (cfg["piv"]["passes"] - 1 - k)
        ov = tuple(cfg["piv"]["overlap"]) if k == cfg["piv"]["passes"] - 1 else (size // 2, size // 2)
        args = ((h, w), (size, size), ov, (h - size) // (size - ov[0]) + 1, (w - size) // (size - ov[1]) + 1)
        if prev is None:  # the first pass needs each uint8 frame's windows once
            assert frozen.pairs_bound(stack, args) == port.pairs_bound(stack, args)
            total += port.pairs_bound(stack, args)[0]
        else:  # a deformed pass: two float32 frames a pair
            assert frozen.pairs_bound(pairs, args, pair_stride=2) == port.pairs_bound(pairs, args, pair_stride=2)
            total += port.pairs_bound(pairs, args, pair_stride=2)[0]
            u = torch.empty((n - 1, prev[3], prev[4]), dtype=torch.float32, **meta)
            assert frozen.deform_bound(frames, u) == port.deform_bound(frames, u)
            deform += port.deform_bound(frames, u)[0]
        prev = args
    assert bounds["piv_pairs"] == pytest.approx(total, rel=1e-12)
    assert bounds["deform_pairs"] == pytest.approx(deform, rel=1e-12)
