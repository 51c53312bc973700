"""Device activity from a torch.profiler trace, and host stages from the
program's structured log.

The profiler's Chrome trace holds every kernel, copy and memset the card
ran, and the benchmark's own `record_function` markers, on one clock.  The
card is busy for the union of those activities' intervals (overlapping
ones count once); the rest of the traced window is idle, and each idle gap
is named by the host stage that was running at its middle.
"""

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset")
MARK_START = "bm.trace.start"
MARK_END = "bm.trace.end"
NAME_CHARS = 120

Interval = Tuple[float, float]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, merged intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def busy(intervals: Sequence[Interval], lo: float, hi: float) -> float:
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The idle stretches of [lo, hi] between the merged intervals."""
    out, t = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def stage_at(t: float, stages: Sequence[Tuple[str, float, float]]) -> str:
    """The names of the host stages running at time t, joined by '+'."""
    names = sorted({n for n, a, b in stages if a <= t < b})
    return "+".join(names) if names else "between stages"


def idle_by_stage(intervals, lo, hi, stages) -> Dict[str, float]:
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps(intervals, lo, hi):
        out[stage_at((a + b) / 2, stages)] += b - a
    return dict(out)


class DeviceTrace:
    """The device side of one traced window, in seconds on the host's
    time.time() clock."""

    def __init__(self, ops: List[Tuple[str, float, float]], lo: float,
                 hi: float):
        self.ops = ops              # (name, start, end)
        self.lo, self.hi = lo, hi

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return busy([(a, b) for _, a, b in self.ops], self.lo, self.hi)

    def time_of(self, patterns: Sequence[str]) -> Tuple[float, int]:
        """Summed device seconds and count of the ops whose name holds one
        of `patterns`."""
        hits = [(b - a) for n, a, b in self.ops
                if any(p in n for p in patterns)]
        return sum(hits), len(hits)

    def top_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for n, a, b in self.ops:
            tot[n[:NAME_CHARS]] += b - a
        return [[n, s] for n, s in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, stages, k: int = 10) -> List[list]:
        by = idle_by_stage([(a, b) for _, a, b in self.ops], self.lo,
                           self.hi, stages)
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:k]]


def from_chrome(path: str, host_mark: float) -> Optional[DeviceTrace]:
    """Read an exported Chrome trace.  `host_mark` is the time.time() at
    which the MARK_START annotation was entered; it maps the trace's clock
    onto the host's.  None when the trace holds no start and end marks."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    marks: Dict[str, float] = {}
    ops = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        name = str(e.get("name", ""))
        if name in (MARK_START, MARK_END) and "annotation" in cat \
                and "gpu" not in cat:
            marks[name] = float(e["ts"])
        elif cat in DEVICE_CATS:
            ts = float(e["ts"])
            ops.append((name, ts, ts + float(e.get("dur", 0.0))))
    if MARK_START not in marks or MARK_END not in marks:
        return None
    off = host_mark - marks[MARK_START] * 1e-6
    ops = [(n, a * 1e-6 + off, b * 1e-6 + off) for n, a, b in ops]
    return DeviceTrace(ops, host_mark, marks[MARK_END] * 1e-6 + off)


def read_events(path: str) -> List[dict]:
    """The program's structured log (one JSON object a line)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
    except FileNotFoundError:
        pass
    return out


def stage_intervals(events: Sequence[dict], prefix_of: Dict[str, str]
                    ) -> List[Tuple[str, float, float]]:
    """Host stage intervals (name, start, end) from batch events: an event
    is logged at its batch's end (`ts`), lasted `wall_s`, and its `stages`
    follow one another in the order logged."""
    out = []
    for e in events:
        prefix = prefix_of.get(e.get("event"))
        if prefix is None or not e.get("stages"):
            continue
        t = e["ts"] - e["wall_s"]
        for name, sec in e["stages"].items():
            out.append((f"{prefix}.{name}", t, t + sec))
            t += sec
    return out
