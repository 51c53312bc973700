"""Median ms a request of `Codec.compress`'s `codec.edges` spans (the Canny
stack of each layer and the pull of its edge map), summed."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "codec.compress", lambda t, c: t.sum_ms(c, "codec.edges"))
