"""Host time [ms] in the program's span ``prefetch:full``: the lazy chain's prefetch thread queueing a batch, blocked
while the queue is full (the consumer behind), the window's total over its videos, per video. Nothing where the
program keeps no such record, dropped spans, or recorded another count of videos than the window's."""


def read(ctx):
    try:
        from pyorc_tpu_torch import _trace
    except ImportError:
        return None
    record, n = _trace.summary(), len(ctx["videos"])
    if not n or record["dropped"] or len(record["videos"]) != n:
        return None
    return 1e3 * sum(v["spans"].get("prefetch:full", (0, 0.0))[1] for v in record["videos"].values()) / n
