"""Host time [ms] in the program's ``lazy:*`` spans (``LazyFrames.read_batch``'s decode and upload, and each
op of the chain), per video, from the profiler's record of every host thread."""


def read(ctx):
    trace, videos = ctx["trace"], ctx["videos"]
    if trace is None or not videos:
        return None
    spans = [secs for name, (_, secs) in trace["spans"].items() if name.startswith("lazy:")]
    return 1e3 * sum(spans) / len(videos) if spans else None
