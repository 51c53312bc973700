"""Median ms a request of `Codec.compress`'s `codec.plan` spans (the host
quadtree plan of each layer), summed."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "codec.compress", lambda t, c: t.sum_ms(c, "codec.plan"))
