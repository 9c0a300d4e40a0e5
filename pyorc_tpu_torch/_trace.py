"""The port's own spans and counters, per video, on the profiler's clock.

A span (:func:`span`) marks a stretch of host work at a layer boundary, a
counter (:func:`count`) a number of things done there. Both record only
while a ``torch.profiler`` records (any profile: the benchmark's traced
window, ``PYORC_TPU_PROFILE``, a caller's own), in every thread: the flag
``torch.autograd.profiler._is_profiler_enabled`` is one per process. Off,
:func:`span` is that one flag check and hands back a shared no-op context:
no clock read, no allocation.

On, a span also opens a ``RecordFunction`` of its name (the profiler's own
low-cost form of ``torch.profiler.record_function``: a host event, and no
annotation on the card's timeline), so that it sits in the profiler's trace
beside the card's work, and keeps a record in
memory: its name, start and end in nanoseconds on the clock the profiler
stamps its events with (``time.time_ns``: a kineto event's ``start_ns()``),
the span that was innermost open in the same thread when it started (its
parent), the thread, and the video.

A video id is drawn (:func:`new_video`) when a root ``LazyFrames`` is made
over a frame source (``Video.get_frames``, or a caller wrapping its own
source); views of it keep the root's id. The id drawn last is the process's
current video, and every span and count carries the current video whatever
thread it runs in (the lazy chain's prefetch thread, the masks and the
transect on the PIV Dataset). So the ids hold for one video at a time per
process, as the service and the benchmark run; two videos in flight at once
in one process would need the id handed to each span.

The record keeps at most :data:`CAP` spans and counts the spans past it
(``dropped``). :func:`summary` gives each video's totals.

Spans, by layer (the benchmark's readers in ``benchmark/metrics/`` name the
metric each one feeds):

- accessors: ``frames:normalize_mean`` (``Frames.normalize``'s sampled
  frames read on the device and their float32 mean taken there), the counter
  ``frames:normalize_mean_frames`` (the frames it summed),
  ``frames:project_grid`` (``Frames.project``'s grid, coordinates and
  lon/lat), ``frames:project_maps`` (the ortho maps built, brought down,
  cropped and uploaded), ``mask:<method>`` (each mask), ``mask:apply`` (the
  masks applied), ``transect:get_transect``, ``transect:get_q``,
  ``transect:river_flow``;
- lazy chain: ``lazy:decode``, ``lazy:upload`` and ``lazy:<op>`` (each op of
  the chain on a batch), ``prefetch:full`` (the prefetch thread queueing a
  batch, blocked while the queue is full);
- engine: ``prefetch:wait`` (the consumer blocked on the next batch),
  ``engine:ensemble_finish`` (the ensemble's gated mean plane, its peak and
  the pairs' corr and s2n means, taken on the device that holds the chunks'
  results once their kernels have drained, and the fields brought down: once
  a video), and the counter
  ``engine:chunks`` (each chunk run, each half of an out-of-memory split
  counted).
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import NamedTuple, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

__all__ = ["CAP", "Record", "Recorder", "span", "count", "new_video", "current_video", "summary", "records", "clear",
           "spanned"]

CAP = 1 << 17  # spans kept in memory; ~20 a 1080p video of the benchmark, ~260 a 4K one

clock = time.time_ns  # the clock of the profiler's events (kineto's ``start_ns()``)


class Record(NamedTuple):
    """One span: ``parent`` is the ``id`` of the span innermost open in the same thread at its start."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    thread: int
    video: Optional[int]


class _Off:
    """The span handed out while no profiler records: enters and leaves, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("_recorder", "_name", "_id", "_parent", "_video", "_function", "_start")

    def __init__(self, recorder: "Recorder", name: str):
        self._recorder = recorder
        self._name = name

    def __enter__(self):
        rec = self._recorder
        stack = rec._stack()
        self._parent = stack[-1] if stack else None
        self._id = next(rec._span_ids)
        self._video = rec.video
        stack.append(self._id)
        self._function = _RecordFunctionFast(self._name)
        self._function.__enter__()
        self._start = clock()  # the profiler stamps its event's start at the end of the enter, its end in the exit

    def __exit__(self, *exc):
        self._function.__exit__(*exc)
        end = clock()
        rec = self._recorder
        rec._stack().pop()
        rec._add(Record(self._id, self._name, self._start, end, self._parent, threading.get_ident(), self._video))
        return False


class Recorder:
    """Spans and counters in memory, per video (the module's functions use one of these for the process)."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.video: Optional[int] = None
        self._video_ids = itertools.count(1)
        self._span_ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._records: list = []
        self._counts: dict = {}
        self._dropped = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, record: Record) -> None:
        with self._lock:
            if len(self._records) < self.cap:
                self._records.append(record)
            else:
                self._dropped += 1

    def span(self, name: str):
        """A context manager around host work named ``name``: recorded while a profiler records."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the current video's counter ``name`` while a profiler records."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        with self._lock:
            key = (self.video, name)
            self._counts[key] = self._counts.get(key, 0) + n

    def new_video(self) -> int:
        """Draw a video id; it is the current video until the next is drawn."""
        self.video = next(self._video_ids)
        return self.video

    def records(self) -> list:
        """The spans kept, in the order they ended."""
        with self._lock:
            return list(self._records)

    def summary(self) -> dict:
        """``{"videos": {video id: {"spans": {name: (calls, seconds)}, "counters": {name: n}}},
        "dropped": spans past the cap}``; a span's seconds include its children's."""
        with self._lock:
            records, counts, dropped = list(self._records), dict(self._counts), self._dropped
        videos: dict = {}
        for r in records:
            spans = videos.setdefault(r.video, {"spans": {}, "counters": {}})["spans"]
            calls, seconds = spans.get(r.name, (0, 0.0))
            spans[r.name] = (calls + 1, seconds + (r.end_ns - r.start_ns) / 1e9)
        for (video, name), n in counts.items():
            videos.setdefault(video, {"spans": {}, "counters": {}})["counters"][name] = n
        return {"videos": videos, "dropped": dropped}

    def clear(self) -> None:
        """Forget every span and count (the current video stays)."""
        with self._lock:
            self._records.clear()
            self._counts.clear()
            self._dropped = 0


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
new_video = RECORDER.new_video
records = RECORDER.records
summary = RECORDER.summary
clear = RECORDER.clear


def current_video() -> Optional[int]:
    """The video id drawn last in this process (None before the first)."""
    return RECORDER.video


def spanned(name: str):
    """Decorate a function so that each call is the span ``name``."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return decorate
