"""Median ms a batch of the program's 'push' stage (host f32-to-u8 conversion and upload), from the
'encode_batch' events of its structured log."""

from benchmark.harness import readers


def read(ctx):
    return readers.stage_median_ms(ctx, "encode_batch", "push")
