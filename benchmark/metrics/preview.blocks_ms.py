"""Median ms a request of `Codec.compress`'s `codec.blocks` spans (each
layer's buckets: uploads, DCT and quantize, pulls), summed."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "codec.compress", lambda t, c: t.sum_ms(c, "codec.blocks"))
