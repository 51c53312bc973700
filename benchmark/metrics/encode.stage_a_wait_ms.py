"""Median ms a batch in which stage A's host blocked on the card: the
`sync.*` spans under `encode.stage_a` (the hysteresis's convergence checks
and the pull of the packed levels), summed."""

from benchmark.metrics import _spans


def _wait(tree, batch):
    stage = [r for r in tree.below(batch) if r["name"] == "encode.stage_a"]
    vals = [v for v in (tree.sum_ms(s, "sync.", prefix=True) for s in stage)
            if v is not None]
    return sum(vals) if vals else None


def read(ctx):
    return _spans.median_per(ctx, "encode.batch", _wait)
