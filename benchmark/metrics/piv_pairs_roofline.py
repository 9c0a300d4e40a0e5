"""The piv_pairs kernel's share [%] of its roofline: the frozen bound of the work the window's videos asked of
it (``work.video_bounds`` on the route's grid, ``ctx["grid"]``) over the kernel's device time in the trace.
Nothing where the cell does not run it."""

import devtrace
import work


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    seconds = devtrace.kernel_seconds(trace, work.KERNELS["piv_pairs"])
    cfg, grid = ctx["cfg"], ctx["grid"]
    bound_ms = sum(work.video_bounds(cfg, v["n_frames"], grid).get("piv_pairs", 0.0) for v in ctx["videos"])
    if seconds <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms / 1e3 / seconds
