"""Median a batch of the rounds the Canny hysteresis's banded path ran
(`hysteresis_rounds`, up to the round that found the fixpoint), summed
over the batch's layer groups; None where every plane took the resident
path (no group counts rounds)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "encode.batch",
        lambda t, b: _spans.count(t.below(b), "hysteresis_rounds"))
