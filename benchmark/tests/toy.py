"""Small copies of the benchmark's cells that the CPU runs in seconds: the same route (chain, camera model,
traffic and comparison) as the cell, at frames of 120 x 200 px (the windows cut to fit: 32 -> 16 -> 8 px
multipass, 16 px ensemble) and 8 or 16 frames a video."""

from __future__ import annotations

import hashlib
import json
import shutil
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


def digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def copy_bench(root: Path) -> dict:
    """A copy of the benchmark beside its BENCHMARK.json in ``root``, and the digests of the copy's files."""
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return digests(root / "benchmark")


def add_cell(root: Path, cfg: dict, traffic: str, metric=None, per_layer=()) -> str:
    """The configuration ``cfg`` as a new file in the copy at ``root``, and new entries for it and its cell on the
    traffic ``traffic`` appended to the copy's BENCHMARK.json (a data file, not code): a new per-layer ``metric``
    for the cell, and the cell in the ``workloads`` of the per-layer metrics named in ``per_layer``; returns the
    cell's name."""
    (root / "benchmark" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                             "file": f"benchmark/configs/{cfg['name']}.json", "reduced": [], "why": "a toy"})
    name = f"{cfg['name']}.{traffic}"
    bench["workloads"].append({"name": name, "config": cfg["name"], "traffic": traffic, "chips": 1, "why": "a toy"})
    for m in bench["per_layer"]:
        if m["name"] in per_layer:
            m["workloads"].append(name)
    if metric is not None:
        bench["per_layer"].append({**metric, "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return name
