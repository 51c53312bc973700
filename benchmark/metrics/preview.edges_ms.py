"""Median ms a request of the `stage_a.canny` spans under `Codec.compress`'s
root (the Canny stack of each layer group in the batch path's stage A, its
hysteresis checks included), summed."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "codec.compress", lambda t, c: t.sum_ms(c, "stage_a.canny"))
