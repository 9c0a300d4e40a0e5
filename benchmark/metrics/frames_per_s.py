"""Frames of the videos completed in the window, over the time from the window's start to the last completion."""


def read(ctx):
    videos = ctx["videos"]
    if not videos:
        return None
    return sum(v["n_frames"] for v in videos) / videos[-1]["end_s"]
