"""A configuration, a traffic mix and a per-layer metric added as new files plus new BENCHMARK.json
entries, with no file that is there edited, are found and run by name."""

import hashlib
import json
import shutil

from toy import BENCH, ROOT, run_toy, toy_cell


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_without_an_edit(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "benchmark")

    # the new files: a configuration, a traffic mix and a metric's reader
    cfg = json.loads((BENCH / "configs" / "ngwerere_1080p_mp26.json").read_text())
    cfg.update(name="toy_single", piv={**cfg["piv"], "passes": 1})
    (tmp_path / "benchmark" / "configs" / "toy_single.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark" / "workloads" / "toy_pairs.json").write_text(
        json.dumps({"frames_per_video": 8, "ring_frames": 16, "clients": 1, "loop": "closed"}))
    (tmp_path / "benchmark" / "metrics" / "toy_frames.py").write_text(
        "def read(ctx):\n    return float(sum(v['n_frames'] for v in ctx['videos']))\n")

    # the new entries, appended to the copy's BENCHMARK.json (a data file, not code)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_single", "source": cfg["source"], "file": "benchmark/configs/toy_single.json",
                             "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "toy_single.toy_pairs", "config": "toy_single", "traffic": "toy_pairs",
                               "chips": 1, "why": "a toy"})
    bench["per_layer"].append({"name": "toy_frames", "unit": "frames", "better": "higher", "source": "host_clock",
                               "layer": "accessors", "moves": "frames_per_s", "workloads": ["toy_single.toy_pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = toy_cell("toy_single.toy_pairs", root=tmp_path)
    cell["traffic"].update(frames_per_video=8, ring_frames=16)
    assert cell["cfg"]["piv"]["passes"] == 1
    assert "toy_frames" in {m["name"] for m in cell["per_layer"]}
    out = run_toy("toy_single.toy_pairs", root=tmp_path, trace=True, cell=cell)
    assert out["result"]["correct"], out["numbers"]
    assert out["result"]["metrics"]["toy_frames"]["value"] == 8.0 * out["result"]["attempted"]
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
