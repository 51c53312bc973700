"""What the metric readers (`benchmark/metrics/<name>.py`) share.

A reader gets the run's context: `calls` (host perf_counter start and end
of each timed call), `mpix_per_call`, `setup_s`, `spans` (the harness's
own (name, start, end) intervals on time.time()), `events` (the program's
structured log records from the window), `trace` (the profiled
sub-window's device activity, trace.DeviceTrace, or None), `work` (the
leaves of the profiled calls' containers), `config`, `traffic`, `peaks`,
`log`, and `metric`, the name it reads.  It returns a number, or None
when the run holds nothing to read.
"""

import statistics
from typing import Optional

from ..reference.codec import layer_shapes
from .check import codec_settings


def rate_mpix_s(ctx) -> Optional[float]:
    """Megapixels of every call over the time from the first call's start
    to the last call's end."""
    if not ctx.calls:
        return None
    span = ctx.calls[-1][1] - ctx.calls[0][0]
    return ctx.mpix_per_call * len(ctx.calls) / span


def percentile_ms(ctx, q: float) -> Optional[float]:
    """The q-th percentile of the calls' latencies (linear interpolation)."""
    lat = sorted(b - a for a, b in ctx.calls)
    if not lat:
        return None
    pos = (len(lat) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(lat) - 1)
    return 1e3 * (lat[lo] + (lat[hi] - lat[lo]) * (pos - lo))


def stage_median_ms(ctx, event: str, stage: str) -> Optional[float]:
    """Median over the window's batches of one stage of the program's
    batch events (seconds in `stages`)."""
    vals = [e["stages"][stage] for e in ctx.events
            if e.get("event") == event and stage in (e.get("stages") or {})]
    return 1e3 * statistics.median(vals) if vals else None


def span_median_ms(ctx, name: str) -> Optional[float]:
    vals = [b - a for n, a, b in ctx.spans if n == name]
    return 1e3 * statistics.median(vals) if vals else None


def idle_share(ctx) -> Optional[float]:
    """Per cent of the traced window in which the card ran nothing."""
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def layer_areas(ctx):
    """[(h, w)] of the three layers of one image of the deployment."""
    img = ctx.config["images"]
    return layer_shapes(codec_settings(ctx.config),
                        (img["height"], img["width"]))


def least_seconds(ctx, flops: float, nbytes: float) -> Optional[float]:
    """The least time the card needs: max(bytes / bandwidth, FP32 operations
    / FP32 rate), from the table of peaks."""
    p = ctx.peaks
    if p is None:
        return None
    return max(nbytes / p["bytes_per_s"], flops / p["fp32_per_s"])


def roofline(ctx, name: str, patterns, flops: float, nbytes: float
             ) -> Optional[float]:
    """Per cent of the device time of the ops named by `patterns` that the
    least time for (flops, nbytes) makes up."""
    if ctx.trace is None:
        return None
    dev_s, n = ctx.trace.time_of(patterns)
    least = least_seconds(ctx, flops, nbytes)
    if not n or dev_s <= 0 or least is None:
        return None
    ctx.log(f"{name}: {flops:.6g} FP32 operations, {nbytes:.6g} bytes "
            f"needed; least {least * 1e3:.6f} ms against {dev_s * 1e3:.6f} "
            f"device ms in {n} launches")
    return 100.0 * least / dev_s
