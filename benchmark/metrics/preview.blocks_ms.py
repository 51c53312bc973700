"""Median ms a request of the `encode.device` stage under `Codec.compress`'s
root: only the wait on stage B (the blocks' DCT and quantize tables) that
is left once the plans are built, since stage B runs on the card while the
host plans; it reads near 0 where the plans take longer than stage B."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "codec.compress", lambda t, c: t.sum_ms(c, "encode.device"))
