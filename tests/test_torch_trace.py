"""The port's own spans and counters (``pyorc_tpu_torch._trace``) on the CPU.

A few tiny frames go through ``LazyFrames`` -> normalize -> project -> get_piv
-> masks -> transect -> Q, with and without ``torch.profiler`` running: what
is recorded, with which parent, thread and video id, on which clock, and
what the prefetch queue, the chunk plan and the record's cap add up to.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

import pyorc_tpu_torch
from pyorc_tpu_torch import _trace
from pyorc_tpu_torch.io import video_reader
from pyorc_tpu_torch.ops import piv_kernels
from pyorc_tpu_torch.velocimetry import engine

import chip_smoke

H, W, N, WINDOW, AOI = 120, 160, 8, 16, 20
SPANS = {
    "frames:normalize_mean", "frames:project_grid", "frames:project_maps", "prefetch:wait", "prefetch:full",
    "mask:minmax", "mask:corr", "mask:count", "mask:apply",
    "transect:get_transect", "transect:get_q", "transect:river_flow",
}
LAZY = {"lazy:decode", "lazy:upload", "lazy:normalize", "lazy:project"}  # the chain's spans before the recorder


@pytest.fixture(autouse=True)
def _cpu_device():
    pyorc_tpu_torch.set_device("cpu")
    torch.set_num_threads(2)
    _trace.clear()
    yield
    _trace.clear()


@pytest.fixture(scope="module")
def stack():
    return chip_smoke.advected_stack(H, W, N, "cpu")


@pytest.fixture(scope="module")
def camera():
    return chip_smoke.nadir_camera_config(H, W, gcp_px=15, aoi_px=AOI, window_size=WINDOW)


def _projected(stack, camera):
    da = chip_smoke.lazy_dataarray(chip_smoke.HostFrameSource(stack), camera)
    return da.frames.normalize(samples=4).frames.project()


def _video(stack, camera):
    """One video through the chain as the service's stages call it: the PIV and the discharge."""
    return chip_smoke.run_chain(_projected(stack, camera), WINDOW, camera, {}, aoi_px=AOI)


def _profiler():
    return profile(activities=[ProfilerActivity.CPU], experimental_config=_ExperimentalConfig(profile_all_threads=True))


def test_nothing_recorded_without_a_profiler(stack, camera, monkeypatch):
    def no_clock():
        raise AssertionError("an idle span read the clock")

    monkeypatch.setattr(_trace, "clock", no_clock)
    _video(stack, camera)
    assert _trace.summary() == {"videos": {}, "dropped": 0}
    assert _trace.records() == []
    # off, every span is one shared object: nothing allocated, nothing entered
    assert _trace.span("frames:normalize_mean") is _trace.span("mask:apply")


def test_every_span_recorded_with_its_parent_thread_and_video(stack, camera):
    with _profiler():
        _video(stack, camera)
    video = _trace.current_video()
    recs = _trace.records()
    assert SPANS | LAZY <= {r.name for r in recs}
    assert {r.video for r in recs} == {video}
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.parent is not None:
            parent = by_id[r.parent]
            assert parent.thread == r.thread
            assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
    main = threading.get_ident()
    worker = [r for r in recs if r.thread != main]
    # the prefetch thread decodes, uploads, runs the chain's ops and queues the batches, under the video's id
    assert {"lazy:decode", "lazy:upload", "lazy:normalize", "lazy:project", "prefetch:full"} <= {r.name for r in worker}
    assert {r.name for r in recs if r.thread == main} >= {"prefetch:wait", "frames:normalize_mean", "mask:apply"}
    # the sampled read of normalize's mean waits on the prefetch queue inside its span
    (mean,) = [r for r in recs if r.name == "frames:normalize_mean"]
    assert any(by_id[r.parent].name == "frames:normalize_mean" for r in recs if r.name == "prefetch:wait" and r.parent)
    assert mean.parent is None
    counters = _trace.summary()["videos"][video]["counters"]
    assert counters == {"engine:chunks": 1, "frames:normalize_mean_frames": 4}  # N / samples = 2: frames 0, 2, 4, 6


def test_two_videos_get_two_ids_and_a_view_keeps_its_roots(stack, camera):
    first = chip_smoke.lazy_dataarray(chip_smoke.HostFrameSource(stack), camera).data
    second = chip_smoke.lazy_dataarray(chip_smoke.HostFrameSource(stack), camera).data
    assert second._video_id == first._video_id + 1 == _trace.current_video()
    views = [first[::2], first[1:], first.copy(), first.with_op(lambda f: f), first.with_chain([], crop=(0, 4, 0, 4))]
    assert {v._video_id for v in views} == {first._video_id}
    with _profiler():
        _video(stack, camera)
        _video(stack, camera)
    videos = _trace.summary()["videos"]
    assert len(videos) == 2
    for totals in videos.values():
        assert totals["spans"]["frames:normalize_mean"][0] == 1
        assert totals["spans"]["transect:get_q"][0] == 1


def test_spans_lie_on_the_profilers_clock(stack, camera):
    with _profiler() as prof:
        _video(stack, camera)
    recs = _trace.records()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for r in recs:
        start, end = min(events[r.name], key=lambda se: abs(se[0] - r.start_ns))
        assert abs(start - r.start_ns) <= 50_000 and abs(end - r.end_ns) <= 50_000, (r, start, end)


def test_lazy_span_names_are_the_chains_as_before(stack, camera):
    with _profiler() as prof:
        _video(stack, camera)
    seen = {e.name for e in prof.events() if e.name.startswith("lazy:")}
    assert seen == LAZY
    assert {r.name for r in _trace.records() if r.name.startswith("lazy:")} == LAZY


@pytest.mark.parametrize("chunksize", [3, 5, 20])
def test_engine_chunks_counts_the_plan_and_each_half_of_a_split(stack, camera, monkeypatch, chunksize):
    proj = _projected(stack, camera)
    planned = len(engine._chunk_bounds(N, chunksize))
    with _profiler():
        proj.frames.get_piv(window_size=WINDOW, chunksize=chunksize)
    assert _trace.summary()["videos"][_trace.current_video()]["counters"] == {"engine:chunks": planned}

    routed = piv_kernels.piv_pairs_routed
    refused = []

    def out_of_memory_once(frames, *args, **kwargs):
        if not refused:
            refused.append(frames.shape[0])
            raise torch.cuda.OutOfMemoryError("planted")
        return routed(frames, *args, **kwargs)

    monkeypatch.setattr(piv_kernels, "piv_pairs_routed", out_of_memory_once)
    _trace.clear()
    with _profiler(), pytest.warns(UserWarning, match="retrying as two halves"):
        proj.frames.get_piv(window_size=WINDOW, chunksize=chunksize)
    assert refused
    assert _trace.summary()["videos"][_trace.current_video()]["counters"] == {"engine:chunks": planned + 1}


@pytest.mark.parametrize("chunksize", [3, 20])
def test_ensemble_finish_is_one_span_a_video(stack, camera, chunksize):
    """The ensemble's finish (the gated mean plane, its peak, the pairs' means and the one download) is the span
    ``engine:ensemble_finish``, once a video whatever the chunk plan; the per-pair route has none."""
    proj = _projected(stack, camera)
    with _profiler():
        proj.frames.get_piv(window_size=WINDOW, chunksize=chunksize, ensemble_corr=True)
        proj.frames.get_piv(window_size=WINDOW, chunksize=chunksize)
    (finish,) = [r for r in _trace.records() if r.name == "engine:ensemble_finish"]
    assert finish.parent is None and finish.thread == threading.get_ident()
    assert _trace.summary()["videos"][_trace.current_video()]["spans"]["engine:ensemble_finish"][0] == 1


@pytest.mark.parametrize("slow", ["consumer", "producer"])
def test_prefetch_queue_spans_name_the_slow_side(slow):
    pause = 0.02

    def batch(a, b):
        if slow == "producer":
            time.sleep(pause)
        return a, np.zeros(b - a)

    with _profiler():
        for _ in video_reader.BatchPrefetcher(batch, [(i, i + 1) for i in range(6)], depth=1):
            if slow == "consumer":
                time.sleep(pause)
    spans = _trace.summary()["videos"][_trace.current_video()]["spans"]
    blocked, idle = ("prefetch:full", "prefetch:wait") if slow == "consumer" else ("prefetch:wait", "prefetch:full")
    assert spans[blocked][1] >= 3 * pause
    assert spans[blocked][1] > 3 * spans[idle][1]


def test_the_cap_counts_what_it_drops():
    recorder = _trace.Recorder(cap=3)
    with _profiler():
        for i in range(5):
            with recorder.span(f"step:{i}"):
                recorder.count("steps")
    assert [r.name for r in recorder.records()] == ["step:0", "step:1", "step:2"]
    summary = recorder.summary()
    assert summary["dropped"] == 2
    assert summary["videos"][None]["counters"] == {"steps": 5}
    recorder.clear()
    assert recorder.summary() == {"videos": {}, "dropped": 0}


def test_operators_profile_shows_the_prefetch_spans(stack, camera, monkeypatch, tmp_path):
    """``PYORC_TPU_PROFILE``'s Chrome trace of the PIV loop holds the engine's wait on the prefetch queue."""
    proj = _projected(stack, camera)
    monkeypatch.setenv("PYORC_TPU_PROFILE", str(tmp_path))
    proj.frames.get_piv(window_size=WINDOW)
    (trace,) = tmp_path.glob("piv_trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "prefetch:wait" in names
    assert _trace.summary()["videos"][_trace.current_video()]["counters"] == {"engine:chunks": 1}
