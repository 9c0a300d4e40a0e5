"""Host time [ms] in the program's span ``frames:normalize_mean`` (``Frames.normalize``'s sampled frames read as
the chain's device batches and added one by one into a float32 frame on the device, divided there by their count:
nothing comes down to the host), the window's total over its videos, per video. Nothing where the program keeps no
such record, dropped spans, or recorded another count of videos than the window's."""


def read(ctx):
    try:
        from pyorc_tpu_torch import _trace
    except ImportError:
        return None
    record, n = _trace.summary(), len(ctx["videos"])
    if not n or record["dropped"] or len(record["videos"]) != n:
        return None
    return 1e3 * sum(v["spans"].get("frames:normalize_mean", (0, 0.0))[1] for v in record["videos"].values()) / n
