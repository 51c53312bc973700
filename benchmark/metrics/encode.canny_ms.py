"""Median ms a batch of the program's `stage_a.canny` spans (the Canny
stack of each layer group in stage A, its hysteresis checks included),
summed over the batch's groups."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "encode.batch", lambda t, b: t.sum_ms(b, "stage_a.canny"))
