"""Median ms a batch of the program's 'assemble' stage (native stream assembly and deflate), from the
'encode_batch' events of its structured log."""

from benchmark.harness import readers


def read(ctx):
    return readers.stage_median_ms(ctx, "encode_batch", "assemble")
