"""Median ms a request of the `encode.plans` stage under `Codec.compress`'s
root (the host's quadtree plans from the pulled levels; stage B runs on the
card meanwhile)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "codec.compress", lambda t, c: t.sum_ms(c, "encode.plans"))
