"""Median ms a request of the `encode.assemble` stage under
`Codec.compress`'s root (the native stream assembly with its deflate at the
deployment's entropy level, and the container's bytes)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "codec.compress", lambda t, c: t.sum_ms(c, "encode.assemble"))
