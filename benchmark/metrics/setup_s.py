"""Seconds from the process's start to the first measured video: imports, the kernel library's load (and
build, in a checkout's first run), the ring made on the card from the seed, and one warm-up video."""


def read(ctx):
    return ctx["setup_s"]
