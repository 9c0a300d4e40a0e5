"""The readers of the program's own spans and counters (``pyorc_tpu_torch._trace``): their arithmetic on a toy
record, nothing where the record dropped spans, counts another number of videos or is not there (a program without
it), and every one of them in a traced toy run of each cell, within the benchmark's spans around the same calls."""

import sys

import pytest

from toy import BENCH, CELLS, run_toy

import run

READERS = ("normalize_mean_ms", "project_host_ms", "batch_wait_ms", "batch_full_ms", "mask_ms", "transect_ms",
           "piv_chunks")

TOY = {
    "videos": {
        7: {"spans": {"frames:normalize_mean": (1, 0.25), "frames:project_grid": (1, 0.03),
                      "frames:project_maps": (1, 0.07), "prefetch:wait": (4, 0.5), "prefetch:full": (5, 0.125),
                      "mask:minmax": (1, 0.01), "mask:count": (1, 0.02), "mask:apply": (1, 0.03),
                      "transect:get_transect": (1, 0.04), "transect:get_q": (1, 0.005),
                      "transect:river_flow": (1, 0.001), "lazy:decode": (3, 9.0)},
            "counters": {"engine:chunks": 41}},
        8: {"spans": {"frames:normalize_mean": (1, 0.75), "frames:project_maps": (1, 0.1), "prefetch:wait": (2, 0.5),
                      "mask:apply": (1, 0.05), "transect:get_q": (1, 0.004)},
            "counters": {"engine:chunks": 39}},
    },
    "dropped": 0,
}
# per video over the toy's two: the window's totals halved
WANT = {"normalize_mean_ms": 500.0, "project_host_ms": 100.0, "batch_wait_ms": 500.0, "batch_full_ms": 62.5,
        "mask_ms": 55.0, "transect_ms": 25.0, "piv_chunks": 40.0}


def _read(name, ctx):
    return run.reader(BENCH / "metrics", name)(ctx)


@pytest.fixture
def toy_record(monkeypatch):
    from pyorc_tpu_torch import _trace

    record = {"videos": dict(TOY["videos"]), "dropped": 0}
    monkeypatch.setattr(_trace, "summary", lambda: record)
    return record


def test_readers_on_a_toy_record(toy_record):
    ctx = {"videos": [{}, {}]}
    for name in READERS:
        assert _read(name, ctx) == pytest.approx(WANT[name], rel=1e-12), name


@pytest.mark.parametrize("fault", ["dropped", "more_videos", "fewer_videos", "no_videos", "no_recorder"])
def test_readers_read_nothing_from_a_record_they_cannot_trust(toy_record, monkeypatch, fault):
    ctx = {"videos": [{}, {}]}
    if fault == "dropped":
        toy_record["dropped"] = 1
    elif fault == "more_videos":
        toy_record["videos"][9] = {"spans": {"mask:apply": (1, 0.1)}, "counters": {}}
    elif fault == "fewer_videos":
        del toy_record["videos"][8]
    elif fault == "no_videos":
        ctx, toy_record["videos"] = {"videos": []}, {}
    else:  # a program without the recorder, as the parent of the change that added it
        import pyorc_tpu_torch

        monkeypatch.delattr(pyorc_tpu_torch, "_trace")
        monkeypatch.setitem(sys.modules, "pyorc_tpu_torch._trace", None)
    for name in READERS:
        assert _read(name, ctx) is None, name


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_toy_run_reports_every_reader(name):
    from pyorc_tpu_torch import _trace

    _trace.clear()  # the record is the process's: another test's traced run would count its videos too
    out = run_toy(name, trace=True)
    metrics = {k: v["value"] for k, v in out["result"]["metrics"].items()}
    assert out["result"]["correct"], out["numbers"]
    assert set(READERS) <= set(metrics), sorted(metrics)
    # the program's spans lie inside the benchmark's spans around the same calls
    assert 0 < metrics["normalize_mean_ms"] + metrics["project_host_ms"] <= metrics["chain_setup_ms"]
    assert 0 < metrics["mask_ms"] + metrics["transect_ms"] <= metrics["mask_transect_ms"]
    assert metrics["piv_chunks"] >= 1 and metrics["batch_wait_ms"] > 0 and metrics["batch_full_ms"] > 0
    assert len(_trace.summary()["videos"]) == out["result"]["attempted"]
