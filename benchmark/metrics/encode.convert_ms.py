"""Median ms a batch of the program's `encode.convert` span, inside push: on
the card the staging of the float32 images into pinned memory (by the copy
pool from 8 MiB a batch), elsewhere `_host_batch`'s f32-to-u8 conversion."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "encode.batch", lambda t, b: t.sum_ms(b, "encode.convert"))
