"""Bytes [MB] the program copied between host and card (its ``_device.COPY_BYTES``, both ways), per video."""


def read(ctx):
    moved = [v["copy"]["h2d"] + v["copy"]["d2h"] for v in ctx["videos"]]
    return sum(moved) / len(moved) / 1e6 if moved else None
