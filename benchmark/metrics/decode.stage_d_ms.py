"""Median ms a batch of the program's 'device' stage (the device stage D, synchronised), from the
'decode_batch' events of its structured log."""

from benchmark.harness import readers


def read(ctx):
    return readers.stage_median_ms(ctx, "decode_batch", "device")
