"""Host time [ms] in the program's ``mask:*`` spans (each mask's computation, and ``mask:apply``: the Dataset copied
and masked), the window's total over its videos, per video. Nothing where the program keeps no such record, dropped
spans, or recorded another count of videos than the window's."""


def read(ctx):
    try:
        from pyorc_tpu_torch import _trace
    except ImportError:
        return None
    record, n = _trace.summary(), len(ctx["videos"])
    if not n or record["dropped"] or len(record["videos"]) != n:
        return None
    return 1e3 * sum(secs for v in record["videos"].values() for name, (_, secs) in v["spans"].items()
                     if name.startswith("mask:")) / n
