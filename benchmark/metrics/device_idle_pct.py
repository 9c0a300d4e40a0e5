"""The share [%] of the traced window in which the card ran nothing: 100 less the union of its kernels,
copies and sets over the window."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
