"""Host time [ms] in the program's span ``engine:ensemble_finish`` (the ensemble's gated mean plane, its peak and the
pairs' corr and s2n means taken on the device that holds the chunks' results once their kernels have drained, and the
fields brought down), the window's total over its videos, per video. Nothing where no video of the record has the
span (a program that finishes the ensemble on the host, or a cell without ensemble PIV), where the program keeps no
such record, dropped spans, or recorded another count of videos than the window's."""

NAME = "engine:ensemble_finish"


def read(ctx):
    try:
        from pyorc_tpu_torch import _trace
    except ImportError:
        return None
    record, n = _trace.summary(), len(ctx["videos"])
    if not n or record["dropped"] or len(record["videos"]) != n:
        return None
    spans = [v["spans"][NAME] for v in record["videos"].values() if NAME in v["spans"]]
    if not spans:
        return None
    return 1e3 * sum(seconds for _, seconds in spans) / n
