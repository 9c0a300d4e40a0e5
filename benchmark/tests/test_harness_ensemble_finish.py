"""The reader of the program's span ``engine:ensemble_finish`` (``metrics/ensemble_finish_ms.py``): its arithmetic on a
toy record, nothing where no video has the span (a program that finishes the ensemble on the host, or a cell without
ensemble PIV), nothing where the record cannot be trusted, and in a traced toy run of each cell: inside
``get_piv_ms`` where the cell runs ensemble PIV, absent where it does not."""

import sys

import pytest

from toy import BENCH, CELLS, run_toy

import run

NAME = "ensemble_finish_ms"


def _read(ctx):
    return run.reader(BENCH / "metrics", NAME)(ctx)


def _record(with_span=True):
    finish = {"engine:ensemble_finish": (1, 0.004)} if with_span else {}
    return {
        "videos": {
            7: {"spans": {"prefetch:wait": (4, 0.5), **finish}, "counters": {"engine:chunks": 41}},
            8: {"spans": {"mask:apply": (1, 0.05), "engine:ensemble_finish": (1, 0.006)} if with_span else {},
                "counters": {"engine:chunks": 39}},
        },
        "dropped": 0,
    }


@pytest.fixture
def toy_record(monkeypatch):
    from pyorc_tpu_torch import _trace

    holder = {"record": _record()}
    monkeypatch.setattr(_trace, "summary", lambda: holder["record"])
    return holder


def test_the_window_total_per_video(toy_record):
    assert _read({"videos": [{}, {}]}) == pytest.approx(1e3 * (0.004 + 0.006) / 2, rel=1e-12)


def test_nothing_from_a_record_without_the_span(toy_record):
    toy_record["record"] = _record(with_span=False)
    assert _read({"videos": [{}, {}]}) is None


@pytest.mark.parametrize("fault", ["dropped", "more_videos", "fewer_videos", "no_videos", "no_recorder"])
def test_nothing_from_a_record_it_cannot_trust(toy_record, monkeypatch, fault):
    ctx, record = {"videos": [{}, {}]}, toy_record["record"]
    if fault == "dropped":
        record["dropped"] = 1
    elif fault == "more_videos":
        record["videos"][9] = {"spans": {"engine:ensemble_finish": (1, 0.1)}, "counters": {}}
    elif fault == "fewer_videos":
        del record["videos"][8]
    elif fault == "no_videos":
        ctx, record["videos"] = {"videos": []}, {}
    else:  # a program without the recorder
        import pyorc_tpu_torch

        monkeypatch.delattr(pyorc_tpu_torch, "_trace")
        monkeypatch.setitem(sys.modules, "pyorc_tpu_torch._trace", None)
    assert _read(ctx) is None


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_toy_run_reports_it_where_the_cell_runs_ensemble_piv(name):
    from pyorc_tpu_torch import _trace

    _trace.clear()  # the record is the process's: another test's traced run would count its videos too
    out = run_toy(name, trace=True)
    metrics = {k: v["value"] for k, v in out["result"]["metrics"].items()}
    assert out["result"]["correct"], out["numbers"]
    if run.load_cell(run.ROOT, name)["cfg"]["piv"]["ensemble_corr"]:
        assert 0 < metrics[NAME] <= metrics["get_piv_ms"]
    else:
        assert NAME not in metrics
