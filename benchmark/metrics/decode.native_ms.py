"""Median ms a batch of the program's `parse.native` span: the one native
call that inflates, replays and scatters every layer of the batch, inside
parse."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "decode.batch", lambda t, b: t.sum_ms(b, "parse.native"))
