"""Median ms a request of `Codec.compress`'s `codec.deflate` span (the
container's zlib streams, `ContainerWriter.tobytes`)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "codec.compress", lambda t, c: t.sum_ms(c, "codec.deflate"))
