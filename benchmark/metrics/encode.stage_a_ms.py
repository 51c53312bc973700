"""Median ms a batch of the program's 'stage_a' stage (stage A: colour, resize, Canny, pyramid, to the packed levels on the host), from the
'encode_batch' events of its structured log."""

from benchmark.harness import readers


def read(ctx):
    return readers.stage_median_ms(ctx, "encode_batch", "stage_a")
