"""Median ms a batch of the program's `encode.convert` span (`_host_batch`,
the host f32-to-u8 conversion of the images, inside push)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "encode.batch", lambda t, b: t.sum_ms(b, "encode.convert"))
