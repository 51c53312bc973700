"""What the readers of the program's own spans share.

The program's tracer (`aejpeg_tpu_torch/utils/log.py`, on in a traced
run) writes one record a span: `event` "span", name, id, parent, root,
start_ns / end_ns on the epoch clock, cpu_ns (the thread's CPU time over
the span) and counts.  A reader groups the window's spans by a group span
(a stream's `encode.batch` or `decode.batch`, a preview's `codec.compress`
root), reads one number from each group's descendants, and returns the
median over the groups; None when the window holds no such group (a
program without spans).
"""

import statistics
from collections import defaultdict
from typing import Callable, Iterable, List, Optional


def ms(rec: dict) -> float:
    return (rec["end_ns"] - rec["start_ns"]) / 1e6


class Tree:
    """The window's span records, by id and by parent."""

    def __init__(self, events: Iterable[dict]):
        self.spans = [e for e in events if e.get("event") == "span"]
        self.kids = defaultdict(list)
        for r in self.spans:
            self.kids[r["parent"]].append(r)

    def named(self, name: str) -> List[dict]:
        return sorted((r for r in self.spans if r["name"] == name),
                      key=lambda r: r["start_ns"])

    def below(self, rec: dict) -> List[dict]:
        """Every descendant of `rec`."""
        out, todo = [], [rec["id"]]
        while todo:
            kids = self.kids.get(todo.pop(), [])
            out.extend(kids)
            todo.extend(k["id"] for k in kids)
        return out

    def sum_ms(self, rec: dict, name: str, prefix: bool = False
               ) -> Optional[float]:
        """Summed ms of the descendants of `rec` named `name` (or whose
        name starts with it); None when there is none."""
        hits = [ms(r) for r in self.below(rec)
                if (r["name"].startswith(name) if prefix
                    else r["name"] == name)]
        return sum(hits) if hits else None



def count(recs: Iterable[dict], name: str) -> Optional[int]:
    """Count `name` summed over `recs`; None when none holds it."""
    vals = [r["counts"][name] for r in recs if name in r["counts"]]
    return sum(vals) if vals else None


def median_per(ctx, group: str,
               value: Callable[[Tree, dict], Optional[float]]
               ) -> Optional[float]:
    """Median over the window's `group` spans of value(tree, span)."""
    tree = Tree(ctx.events)
    vals = [v for v in (value(tree, g) for g in tree.named(group))
            if v is not None]
    return statistics.median(vals) if vals else None
