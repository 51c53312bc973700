"""Median ms a batch in which the host blocked on the Canny hysteresis's
convergence checks: the `sync.hysteresis` spans under the batch, summed;
None where the batch made no check."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "encode.batch", lambda t, b: t.sum_ms(b, "sync.hysteresis"))
