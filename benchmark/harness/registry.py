"""Find the benchmark's pieces by name.

`BENCHMARK.json` at the checkout's root lists the cells and metrics; each
piece lives in a file of its own under `benchmark/`, found by the name the
cell or metric gives:

  configs/<config>.json    a deployment: codec settings, image shape and count
  traffic/<mix>.json       a traffic mix: parameters the generator reads,
                           among them its `kind`
  kinds/<kind>.py          an entry point the generator drives: `Traffic`
  metrics/<metric>.py      a metric's reader: `read(ctx)` -> number or None;
                           a metric `<formula>.<cells>` without a file of
                           its own is read by `metrics/<formula>.py`
  limits/<workload>.json   the limit of each number the cell's check compares
"""

import importlib.util
import json
import os
from typing import Callable, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)


class Registry:
    """The benchmark's files under one directory (`benchmark/` by default;
    tests point it elsewhere)."""

    def __init__(self, bench_dir: str = BENCH_DIR,
                 spec_path: Optional[str] = None):
        self.dir = bench_dir
        self.spec_path = spec_path or os.path.join(
            os.path.dirname(bench_dir), "BENCHMARK.json")

    def _json(self, *parts) -> dict:
        path = os.path.join(self.dir, *parts)
        if not os.path.exists(path):
            raise KeyError(f"no file {path}")
        with open(path) as f:
            return json.load(f)

    def spec(self) -> dict:
        with open(self.spec_path) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.spec()["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.spec_path}")

    def config(self, name: str) -> dict:
        return self._json("configs", f"{name}.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, workload: str) -> dict:
        return self._json("limits", f"{workload}.json")

    def _module(self, folder: str, name: str):
        path = os.path.join(self.dir, folder, f"{name}.py")
        if not os.path.exists(path):
            raise KeyError(f"no file {path}")
        tag = name.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(
            f"bm_{folder}_{tag}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def kind(self, name: str):
        """The traffic class of kind `name`."""
        return self._module("kinds", name).Traffic

    def metric_reader(self, name: str) -> Callable:
        """The reader of metric `name`: metrics/<name>.py, else the file of
        its longest dotted prefix (one formula for several cells)."""
        parts = name.split(".")
        for k in range(len(parts), 0, -1):
            try:
                return self._module("metrics", ".".join(parts[:k])).read
            except KeyError:
                continue
        raise KeyError(f"no reader for {name!r} in {self.dir}/metrics")

    def metrics_of(self, workload: str, trace: bool):
        """[(metric entry)] the cell reports: its end-to-end metrics with
        trace off, its per-layer metrics with trace on."""
        spec = self.spec()
        out = []
        for m in spec["per_layer" if trace else "end_to_end"]:
            cells = m.get("workloads")
            if cells is None and trace:
                moved = next(e for e in spec["end_to_end"]
                             if e["name"] == m["moves"])
                cells = moved.get("workloads")
            if cells is None or workload in cells:
                out.append(m)
        return out
