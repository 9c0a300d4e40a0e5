"""The whole chain's share [%] of the card's peak: the frozen bounds of all the PIV kernels' work that the
window's videos asked for (``work.video_bounds`` on the route's grid, ``ctx["grid"]``), over the length of the
traced window. A kernel taken off the path still counts its work here."""

import work


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace["window_s"] <= 0 or not ctx["videos"]:
        return None
    cfg, grid = ctx["cfg"], ctx["grid"]
    bound_ms = sum(sum(work.video_bounds(cfg, v["n_frames"], grid).values()) for v in ctx["videos"])
    return 100.0 * bound_ms / 1e3 / trace["window_s"]
