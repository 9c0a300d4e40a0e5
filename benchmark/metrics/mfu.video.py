"""The whole chain's share [%] of the card's peak: the frozen bounds of all the PIV kernels' work that the
window's videos asked for (``work.video_bounds``), over the length of the traced window. A kernel taken off
the path still counts its work here."""

import work


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace["window_s"] <= 0 or not ctx["videos"]:
        return None
    bound_ms = sum(sum(work.video_bounds(ctx["cfg"], v["n_frames"]).values()) for v in ctx["videos"])
    return 100.0 * bound_ms / 1e3 / trace["window_s"]
