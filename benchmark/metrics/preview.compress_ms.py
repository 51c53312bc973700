"""Median ms of Codec.compress in a preview request, from the harness's own
span around the call."""

from benchmark.harness import readers


def read(ctx):
    return readers.span_median_ms(ctx, "preview.compress")
