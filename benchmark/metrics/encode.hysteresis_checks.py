"""Median a batch of the Canny hysteresis's convergence checks (one host
sync each), the `hysteresis_checks` counts summed over the batch's layer
groups."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "encode.batch",
        lambda t, b: _spans.count(t.below(b), "hysteresis_checks"))
