"""BENCHMARK.json against the format the benchmark keeps to: names, units, keys, files, metrics and the chip budget."""

import json
import re

import pytest

from toy import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int) and 10 <= bench["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s, 180 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(bench).encode()) <= 64 * 1024


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and (BENCH / "workloads" / f"{w['traffic']}.json").is_file()
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and (BENCH / "metrics" / f"{m['name']}.py").is_file()
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert 1 <= len(m["layer"]) <= 200
    assert len(names) == len(set(names))


def test_every_config_has_a_cell_and_every_cell_its_metrics(bench):
    import run

    assert {w["config"] for w in bench["workloads"]} == {c["name"] for c in bench["configs"]}
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = run.load_cell(ROOT, w["name"])
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in reported, (w["name"], m["name"])
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_config_files_state_their_cut_and_limits(bench):
    import run

    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        route = run.load_route(BENCH, cfg)
        assert set(cfg["limits"]) == set(route.NUMBERS) and "assumed" in cfg and "precision" in cfg
