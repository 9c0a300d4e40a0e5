"""Small copies of the benchmark's cells that the CPU runs in seconds: the same route (chain, camera model,
traffic and comparison) as the cell, at frames of 120 x 200 px (the windows cut to fit: 32 -> 16 -> 8 px
multipass, 16 px ensemble) and 8 or 16 frames a video."""

from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("ngwerere_1080p_mp26.video126", "nadir_4k_ens64.video1800")


def toy_cell(name: str, root: Path = ROOT) -> dict:
    import run

    cell = run.load_cell(root, name)
    cfg = cell["cfg"]
    cfg.update(height=120, width=200, camera={"f": 200.0, "gcp_px": 12, "aoi_px": 10},
               transect={"n_points": 11, "margin_px": 12})
    if cfg["piv"]["ensemble_corr"]:
        cfg["piv"].update(window_size=16, overlap=[8, 8])
        cell["traffic"].update(frames_per_video=16, ring_frames=16)
    else:
        cfg["piv"].update(window_size=8, overlap=[4, 4])
        cell["traffic"].update(frames_per_video=8, ring_frames=16)
    return cell


def run_toy(name: str, program=None, seed: int = 2**31 + 7, root: Path = ROOT, trace: bool = False, cell=None):
    """One run of the toy cell on the CPU with a window of one pass over its distinct videos."""
    import pyorc_tpu_torch

    import run

    pyorc_tpu_torch.set_device("cpu")
    cell = toy_cell(name, root) if cell is None else cell
    return run.run_cell(cell, seed, 0.0, trace, "cpu", program=program, min_passes=1)
