"""Median a request of the host's syncs with the card (`sync` counts, one a
blocking upload, pull or convergence check) under its two roots: the
`codec.compress` span and the first `codec.decompress` after it on the
same thread."""

from benchmark.metrics import _spans


def _syncs(tree, comp):
    after = [d for d in tree.named("codec.decompress")
             if d["thread"] == comp["thread"]
             and d["start_ns"] >= comp["end_ns"]]
    if not after:
        return None
    recs = [comp, after[0]] + tree.below(comp) + tree.below(after[0])
    return _spans.count(recs, "sync")


def read(ctx):
    return _spans.median_per(ctx, "codec.compress", _syncs)
