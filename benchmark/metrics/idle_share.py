"""Per cent of the profiled sub-window in which the card ran nothing: one
minus the union of its kernel, copy and memset intervals over the window.
Reads `idle_share.<cells>` for every cell (idle_share.encode, .decode,
.preview)."""

from benchmark.harness import readers


def read(ctx):
    return readers.idle_share(ctx)
