"""95th percentile of the latency of every preview request in the window
(Codec.compress, then Codec.decompress), in ms."""

from benchmark.harness import readers


def read(ctx):
    return readers.percentile_ms(ctx, 95.0)
