"""Reading a ``torch.profiler`` trace of the measured window: device busy time, kernel times, spans, idle gaps.

The window is the span ``bench:window``. Device activity is every event the profiler recorded on the card
(kernels, copies, sets), its busy time the union of their intervals inside the window. Host spans are the
benchmark's ``bench:*`` spans and the program's ``lazy:*`` spans, recorded in every host thread (the lazy
chain runs in a prefetch thread).
"""

from __future__ import annotations

import contextlib

WINDOW = "bench:window"


def profiler(device):
    """A ``torch.profiler.profile`` of the host's threads and, on a card, the card."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True))


@contextlib.contextmanager
def window():
    import torch

    with torch.profiler.record_function(WINDOW):
        yield


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(prof) -> dict:
    """The trace's numbers [s]: ``window_s``, ``busy_s``, ``device_ops`` {name: seconds},
    ``spans`` {name: (calls, seconds)}, ``span_threads`` (the host threads whose spans were recorded), and
    ``idle_gaps``: [(what the host was doing, seconds)] for every
    stretch of the window in which the card ran nothing, longest first."""
    events = prof.events()
    win = None
    spans, host, threads = {}, [], set()
    device = []
    for e in events:
        kind = e.device_type.name
        rng = e.time_range
        if kind == "CPU":
            if e.name == WINDOW:
                win = (rng.start, rng.end)
            elif e.name.startswith(("bench:", "lazy:")):
                calls, secs = spans.get(e.name, (0, 0.0))
                spans[e.name] = (calls + 1, secs + (rng.end - rng.start) / 1e6)
                threads.add(e.thread)
                if e.name.startswith("bench:"):
                    host.append((rng.start, rng.end, e.name[len("bench:"):]))
        elif kind == "CUDA" and not getattr(e, "is_user_annotation", False) and not e.name.startswith(
                ("bench:", "lazy:")):  # a span's copy on the device's timeline is no device work
            device.append((rng.start, rng.end, e.name))
    if win is None:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    w0, w1 = win
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    ops = {}
    for s, e, n in inside:
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e6
    busy = _union([(s, e) for s, e, _ in inside])
    gaps, cursor = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)

    def doing(t0, t1):
        mid = 0.5 * (t0 + t1)
        open_spans = [(s, n) for s, e, n in host if s <= mid <= e]
        return max(open_spans)[1] if open_spans else "between videos"

    idle = sorted(((doing(a, b), (b - a) / 1e6) for a, b in gaps), key=lambda g: -g[1])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "device_ops": ops,
        "spans": spans,
        "span_threads": len(threads),
        "idle_gaps": idle,
    }


def kernel_seconds(trace: dict, kernel: str) -> float:
    """Device seconds in the trace of the kernels whose name holds ``kernel``."""
    return sum(s for name, s in trace["device_ops"].items() if kernel in name)


def breakdown(trace: dict) -> dict:
    """The result line's ``breakdown``: the device operations that took most time, and the longest idle gaps."""
    ops = sorted(trace["device_ops"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in trace["idle_gaps"][:10]]}
