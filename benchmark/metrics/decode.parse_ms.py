"""Median ms a batch of the program's 'parse' stage (native inflate, state replay and scatter), from the
'decode_batch' events of its structured log."""

from benchmark.harness import readers


def read(ctx):
    return readers.stage_median_ms(ctx, "decode_batch", "parse")
