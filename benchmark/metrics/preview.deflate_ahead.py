"""Median a request of the layers whose deflate `Codec.compress` submitted
before its `codec.deflate` span began (the `deflate_ahead` count on the
`codec.compress` root); None from a program without the count."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.median_per(
        ctx, "codec.compress", lambda t, c: _spans.count([c], "deflate_ahead"))
