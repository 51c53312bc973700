"""What the host did during the window, logged on earlier lines so that
runs that read apart can be told apart: the process's CPU time in user
and system mode, its threads, how the calls' durations spread, and the
window by tenths (calls a second, cores busy, peak resident memory).  A
trend across the tenths is warm-up left in the window; tenths that agree
while whole runs differ mean a process is slow or fast throughout."""

import resource
import statistics
from typing import List, Tuple


def _threads() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Threads:"):
                    return int(line.split()[1])
    except (OSError, ValueError):
        pass
    return 0


class Window:
    """Marks taken at the window's start and after every call."""

    def __init__(self):
        self.rows: List[Tuple[float, float, float, int]] = []

    def mark(self, t: float) -> None:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.rows.append((t, ru.ru_utime, ru.ru_stime, ru.ru_maxrss))

    def summary(self, calls: List[Tuple[float, float]]) -> str:
        first, last = self.rows[0], self.rows[-1]
        dt = last[0] - first[0]
        parts = [f"process user {last[1] - first[1]:.2f} s, "
                 f"system {last[2] - first[2]:.2f} s in {dt:.2f} s",
                 f"threads {_threads()}"]
        durs = [b - a for a, b in calls]
        if len(durs) >= 4:
            q = statistics.quantiles(durs, n=4)
            parts.append(f"calls ms p25 {1e3 * q[0]:.1f} p50 {1e3 * q[1]:.1f}"
                         f" p75 {1e3 * q[2]:.1f} max {1e3 * max(durs):.1f}")
        return "; ".join(parts)

    def tenths(self) -> str:
        calls = self.rows[1:]
        if len(calls) < 10:
            return "too few calls"
        out, prev = [], self.rows[0]
        for k in range(10):
            seg = calls[len(calls) * k // 10:len(calls) * (k + 1) // 10]
            end = seg[-1]
            dt = end[0] - prev[0]
            out.append(f"{len(seg) / dt:.3f}/s u{(end[1] - prev[1]) / dt:.2f}"
                       f" s{(end[2] - prev[2]) / dt:.2f}"
                       f" {end[3] / 1048576:.2f}G")
            prev = end
        return " | ".join(out)
