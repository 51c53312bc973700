"""Median a batch of the per cent of `encode.convert`'s wall time that its
thread spent on a core (`cpu_ns` over the span): 100 means the conversion
ran throughout; less, that it waited for the GIL or for a core of the
shared host."""

from benchmark.metrics import _spans


def _pct(tree, batch):
    conv = [r for r in tree.below(batch) if r["name"] == "encode.convert"]
    wall = sum(r["end_ns"] - r["start_ns"] for r in conv)
    return 100.0 * sum(r["cpu_ns"] for r in conv) / wall if wall else None


def read(ctx):
    return _spans.median_per(ctx, "encode.batch", _pct)
