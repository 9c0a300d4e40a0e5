"""Host time [ms] a video spends in the benchmark's span around the masks, ``get_transect``, ``get_q`` and
``get_river_flow``, per video."""


def read(ctx):
    walls = [v["spans"]["mask_transect"] for v in ctx["videos"]]
    return 1e3 * sum(walls) / len(walls) if walls else None
