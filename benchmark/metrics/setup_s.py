"""Seconds from spawning the server to the window's start: loading, the
store built on the card, kernels loaded (built, in a checkout's first run),
warm-up, the page prewarm, and the mix's own warm traffic."""

LAYER = "end to end"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
