"""Host time [ms] in the program's spans ``frames:project_grid`` (``Frames.project``'s grid, coordinates and lon/lat)
and ``frames:project_maps`` (the ortho maps built on the card and brought down, cropped, and uploaded again), the
window's total over its videos, per video. Nothing where the program keeps no such record, dropped spans, or recorded
another count of videos than the window's."""

NAMES = ("frames:project_grid", "frames:project_maps")


def read(ctx):
    try:
        from pyorc_tpu_torch import _trace
    except ImportError:
        return None
    record, n = _trace.summary(), len(ctx["videos"])
    if not n or record["dropped"] or len(record["videos"]) != n:
        return None
    return 1e3 * sum(v["spans"].get(name, (0, 0.0))[1] for v in record["videos"].values() for name in NAMES) / n
