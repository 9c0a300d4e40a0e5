"""Chunks the PIV engine ran (the program's counter ``engine:chunks``: the chunk plan's chunks, each half of an
out-of-memory split counted), the window's total over its videos, per video. Nothing where the program keeps no such
record, dropped spans, or recorded another count of videos than the window's."""


def read(ctx):
    try:
        from pyorc_tpu_torch import _trace
    except ImportError:
        return None
    record, n = _trace.summary(), len(ctx["videos"])
    if not n or record["dropped"] or len(record["videos"]) != n:
        return None
    return sum(v["counters"].get("engine:chunks", 0) for v in record["videos"].values()) / n
