"""Launches of the PIV correlation kernels (the program's ``piv_kernels.LAUNCHES``: ``piv_pairs`` and
``piv_ensemble``), per video."""


def read(ctx):
    counts = [v["launches"]["piv_pairs"] + v["launches"]["piv_ensemble"] for v in ctx["videos"]]
    return sum(counts) / len(counts) if counts else None
