"""The 90th percentile [s] of the completed videos' wall times, from the wrap of each ``LazyFrames`` to its
discharge on the host (linear between order statistics), in the traced run. A per-layer reading where the
card idles most of the window: the host paces it."""

import numpy as np


def read(ctx):
    walls = [v["wall_s"] for v in ctx["videos"]]
    return float(np.percentile(walls, 90)) if len(walls) >= 10 else None
