"""Host time [ms] a video spends in the benchmark's span around ``get_piv``, through its host arrays: the
lazy chain's batches, the engine and the kernels, per video."""


def read(ctx):
    walls = [v["spans"]["get_piv"] for v in ctx["videos"]]
    return 1e3 * sum(walls) / len(walls) if walls else None
