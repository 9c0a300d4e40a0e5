"""Host time [ms] a video spends in the benchmark's span around ``normalize`` and ``project``: the lazy
chain's set-up (normalize's sampled mean, the ortho maps, the ops queued), per video."""


def read(ctx):
    walls = [v["spans"]["chain_setup"] for v in ctx["videos"]]
    return 1e3 * sum(walls) / len(walls) if walls else None
