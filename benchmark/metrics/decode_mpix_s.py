"""Megapixels decoded per second: every image of every call in the window,
over the time from the first call's start to the last call's end."""

from benchmark.harness import readers


def read(ctx):
    return readers.rate_mpix_s(ctx)
