"""Structured logging for the streaming pipelines.

The reference logs with bare prints (e.g. the sweep progress monitor,
test/analysis/metrics_computation.py:63-135).  For a production codec the
interesting signals are per-batch: sizes, stage wall times, and Mpix/s.
This module emits them as single-line JSON records so they can be tailed,
grepped, or shipped to any log collector — no dependency beyond stdlib.

Usage:
    log = get_logger()                       # honors AEJPEG_LOG env var
    log.event("encode_batch", images=42, mpix=16.5, stages={...})

AEJPEG_LOG values: "" or unset (disabled), "stderr", "stdout", or a file
path (append mode).  `configure()` overrides programmatically.
"""

import json
import os
import sys
import threading
import time
from typing import Any, Optional, TextIO


class StructuredLogger:
    """Thread-safe single-line-JSON event logger."""

    def __init__(self, sink: Optional[TextIO], name: str = "aejpeg"):
        self._sink = sink
        self._name = name
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self._sink is not None

    def event(self, kind: str, **fields: Any) -> None:
        if self._sink is None:
            return
        rec = {"ts": round(time.time(), 6), "logger": self._name,
               "event": kind}
        for k, v in fields.items():
            if isinstance(v, float):
                v = round(v, 6)
            elif isinstance(v, dict):
                v = {kk: (round(vv, 6) if isinstance(vv, float) else vv)
                     for kk, vv in v.items()}
            rec[k] = v
        line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            self._sink.write(line + "\n")
            self._sink.flush()


_NULL = StructuredLogger(None)
_logger: Optional[StructuredLogger] = None
_init_lock = threading.Lock()


def configure(target: Optional[str]) -> StructuredLogger:
    """Set the process-wide logger sink: None/'' disables, 'stderr',
    'stdout', or a file path (append)."""
    global _logger
    if not target:
        _logger = _NULL
    elif target == "stderr":
        _logger = StructuredLogger(sys.stderr)
    elif target == "stdout":
        _logger = StructuredLogger(sys.stdout)
    else:
        _logger = StructuredLogger(open(target, "a"))
    return _logger


def get_logger() -> StructuredLogger:
    """Process-wide logger; first call reads AEJPEG_LOG."""
    global _logger
    if _logger is None:
        with _init_lock:
            if _logger is None:
                configure(os.environ.get("AEJPEG_LOG", ""))
    return _logger
