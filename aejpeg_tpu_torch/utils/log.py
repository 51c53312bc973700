"""The port's tracer: spans, counts and batch events as one-line JSON.

Off unless AEJPEG_LOG names a sink: "stderr", "stdout" or a file path
(append); "" or unset is off.  `configure()` sets it in code.  Off,
`span()` returns one shared no-op context, and `count()` and `note()`
return at once: no clock is read, no record made, no profiler range
entered.

    from aejpeg_tpu_torch.utils.log import count, note, span
    with span("encode.plans"):               # nests under the open span
        ...
        count("hysteresis_checks", 3)        # on the innermost open span
        note("route", "banded")              # an attr of that span
    with span("encode.batch", parent=root, batch=0):   # another thread
        ...

On, while a profiler records the thread, each span also enters
`torch.profiler.record_function(name)`, so the trace holds it (and the
kernels launched under it carry it as their `gpu_user_annotation`).
torch.profiler records the thread that started it, so a stream's worker
threads keep their spans in the log alone.  Spans are stamped on one
monotonic clock (`time.perf_counter_ns()`) plus an offset to the epoch
clock taken at `configure()`: the same epoch clock as a torch.profiler
Chrome trace's `ts` (microseconds) plus its `baseTimeNanoseconds`, so
spans lay over the device's activities with no second mapping.

Records stay in memory and are written in one go when their root span
(the outermost span of a call) closes, at `configure()` and at exit.
Every line has `ts` (seconds on the epoch clock), `logger` ("aejpeg")
and `event`:

  "span"  name, id, parent (id or null), root (id), thread (native id),
          start_ns / end_ns (epoch ns), cpu_ns (the thread's CPU time over
          the span, time.thread_time_ns(), on spans opened with cpu=True:
          encode.convert; null elsewhere), counts ({name: n}), attrs;
          `ts` is end_ns in seconds.  A span named
          "sync.*" (the host blocked on the device: an upload, a pull, a
          convergence check) counts sync = 1.
  "encode_batch" / "decode_batch"  one a stream batch, from its batch
          span: ts (its end), wall_s, batch, images, mpix, bytes (encode),
          stages ({stage: seconds}, encode_batch/decode_batch's timings=).

The span tree of the streams and the per-image Codec:

  encode_stream (root; images, batches, mpix)
    encode.batch (parent: the root, on a worker thread; batch, images)
      encode.push          encode.convert (cpu_ns; attrs route and
                           threads: on the card "pinned", the images'
                           copy into pinned memory by `threads` runs, and
                           the count push_exact_checks, 1 where an image
                           is not marked u8-exact; on the CPU and a mesh
                           "host", _host_batch's rounding, 1 thread),
                           then encode.upload on the card (the upload's
                           enqueue: it does not wait) or sync.upload
      encode.stage_a       sync.exact (on the card, where an image is not
                           marked: the kernel's not-exact words pulled)
                           stage_a.canny (a layer group; attrs planes, h,
                           w and the hysteresis's route: resident or
                           banded on the card, plain on the CPU; counts
                           hysteresis_checks (host checks: 0 where every
                           plane fits the kernel's shared memory) and
                           hysteresis_launches on the card, and on its
                           banded path hysteresis_bands (bands a plane)
                           and hysteresis_rounds (rounds that ran, to the
                           one that found the fixpoint); or
                           hysteresis_checks, hysteresis_steps on the CPU)
                             sync.hysteresis (each host check)
                           sync.levels
      encode.plans, encode.device, encode.pull
      encode.assemble      assemble.native, assemble.containers
  decode_stream (root; images, batches, mpix)
    decode.batch
      decode.parse         parse.containers, parse.arenas, parse.native
      decode.push          sync.upload
      decode.device
      decode.pull          sync.pull
  codec.compress (root)    the encode_batch stages above on one image
                           (encode.push ... encode.assemble, as under
                           encode.batch)
  codec.decompress (root)  the decode_batch stages above on one container
                           (decode.parse ... decode.pull)

The device time under a span is read from a profiler trace: the span's
`record_function` range, or its [start_ns, end_ns] on the trace's clock.
"""

import atexit
import itertools
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, TextIO

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function


_encode = json.JSONEncoder(separators=(",", ":")).encode


class _NoSpan:
    """What `span()` returns when tracing is off: enters and exits
    nothing."""
    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def mark(self, name: str) -> None:
        pass


NO_SPAN = _NoSpan()


class Span:
    """One timed interval of one thread.  Its parent is the innermost span
    open on the thread at entry, or the span passed as `parent` (which may
    live on another thread); its root is its parent's root, or itself.

    Only a span opened with `cpu=True` reads the thread's CPU clock, and a
    span enters its `record_function` range only while a profiler records
    the thread: on an H100's host whose thread CPU clock is a system call
    (ticking in 10 ms), a read measured about 6 µs alone and hundreds of
    µs inside the streams' calls, and a range about 11 µs."""
    __slots__ = ("_log", "name", "id", "parent", "root", "attrs", "counts",
                 "thread", "start", "end", "cpu0", "cpu", "_range")

    def __init__(self, log: "StructuredLogger", name: str, parent,
                 attrs: Dict[str, Any], cpu: bool = False):
        self._log = log
        self.name = name
        self.id = next(log._ids)
        self.parent = parent
        self.attrs = attrs
        self.counts: Dict[str, int] = (
            {"sync": 1} if name.startswith("sync.") else {})
        self.cpu0 = 0 if cpu else None

    def __enter__(self):
        local = self._log._thread()
        stack = local.stack
        parent = self.parent if isinstance(self.parent, Span) else (
            stack[-1] if stack else None)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        stack.append(self)
        self.thread = local.tid
        if self.cpu0 is not None:
            self.cpu0 = time.thread_time_ns()
        self.start = time.perf_counter_ns()
        self._range = None
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self.close(True)
        return False

    def close(self, keep: bool) -> None:
        """End the span; `keep` False drops it unrecorded."""
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self.end = time.perf_counter_ns()
        self.cpu = (None if self.cpu0 is None
                    else time.thread_time_ns() - self.cpu0)
        stack = self._log._thread().stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:          # and any span left open inside it
            del stack[stack.index(self):]
        if keep:
            self._log._finish(self)


class Stages:
    """Back-to-back spans of one call's stages, split at its mark points:
    entry opens `prefix.order[0]`; `mark(name)` ends the open stage (named
    `name`) and opens the next in `order`.  A stage still open at exit
    was never reached and is dropped."""

    def __init__(self, log: "StructuredLogger", prefix: str,
                 order: Sequence[str]):
        self.log = log
        self.names = [f"{prefix}.{n}" for n in order]
        self.open: Optional[Span] = None

    def _next(self) -> None:
        self.open = (Span(self.log, self.names.pop(0), None, {}).__enter__()
                     if self.names else None)

    def __enter__(self):
        self._next()
        return self

    def mark(self, name: str) -> None:
        if self.open is not None:
            self.open.close(True)
        self._next()

    def __exit__(self, *exc):
        if self.open is not None:
            self.open.close(False)
        return False


class StructuredLogger:
    """The process's sink and the records waiting for their roots."""

    def __init__(self, sink: Optional[TextIO], name: str = "aejpeg",
                 owned: bool = False):
        self._sink = sink
        self._name = name
        self._owned = owned
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._pending: Dict[int, List[dict]] = {}
        # perf_counter_ns + offset = epoch ns, the profiler's clock
        self.offset_ns = time.time_ns() - time.perf_counter_ns()

    @property
    def enabled(self) -> bool:
        return self._sink is not None

    def _thread(self) -> threading.local:
        """The calling thread's open spans (`stack`) and native id."""
        local = self._local
        if not hasattr(local, "stack"):
            local.stack = []
            local.tid = threading.get_native_id()
        return local

    def _record(self, kind: str, ts_ns: int, fields: Dict[str, Any]
                ) -> dict:
        rec = {"ts": (ts_ns + self.offset_ns) / 1e9, "logger": self._name,
               "event": kind}
        rec.update(fields)
        return rec

    def _finish(self, s: Span) -> None:
        off = self.offset_ns
        self._add(s.root, self._record("span", s.end, {
            "name": s.name, "id": s.id, "parent": s.parent, "root": s.root,
            "thread": s.thread, "start_ns": s.start + off,
            "end_ns": s.end + off, "cpu_ns": s.cpu, "counts": s.counts,
            "attrs": s.attrs}))
        if s.id == s.root:
            with self._lock:
                recs = self._pending.pop(s.id, [])
            self._write(recs)

    def _add(self, root: int, rec: dict) -> None:
        with self._lock:
            self._pending.setdefault(root, []).append(rec)

    def _write(self, recs: List[dict]) -> None:
        if not recs:
            return
        text = "".join(_encode(r) + "\n" for r in recs)
        with self._lock:
            if self._sink is not None:
                self._sink.write(text)
                self._sink.flush()

    def event(self, kind: str, span: Span, **fields: Any) -> None:
        """A record of the closed `span`, written with its root's spans:
        `ts` is the span's end and `wall_s` its length."""
        if self._sink is None or not isinstance(span, Span):
            return
        fields["wall_s"] = (span.end - span.start) / 1e9
        self._add(span.root, self._record(kind, span.end, fields))

    def flush(self) -> None:
        """Write every record still waiting for its root."""
        with self._lock:
            recs = [r for v in self._pending.values() for r in v]
            self._pending.clear()
        self._write(recs)

    def close(self) -> None:
        self.flush()
        with self._lock:
            sink, self._sink = self._sink, None
        if self._owned:
            sink.close()


_NULL = StructuredLogger(None)
_logger: Optional[StructuredLogger] = None
_init_lock = threading.Lock()
_at_exit = False


def _flush_at_exit() -> None:
    if _logger is not None:
        _logger.flush()


def configure(target: Optional[str]) -> StructuredLogger:
    """Set the process-wide sink: None/'' disables, 'stderr', 'stdout', or
    a file path (append).  Writes what the previous sink still held and
    maps the span clock to the epoch clock anew."""
    global _logger, _at_exit
    if _logger is not None and _logger is not _NULL:
        _logger.close()
    if not target:
        _logger = _NULL
    elif target == "stderr":
        _logger = StructuredLogger(sys.stderr)
    elif target == "stdout":
        _logger = StructuredLogger(sys.stdout)
    else:
        _logger = StructuredLogger(open(target, "a"), owned=True)
    if _logger is not _NULL and not _at_exit:
        atexit.register(_flush_at_exit)
        _at_exit = True
    return _logger


def get_logger() -> StructuredLogger:
    """Process-wide logger; first call reads AEJPEG_LOG."""
    global _logger
    if _logger is None:
        with _init_lock:
            if _logger is None:
                configure(os.environ.get("AEJPEG_LOG", ""))
    return _logger


def span(name: str, parent=None, cpu: bool = False, **attrs: Any):
    """A span as a context manager (NO_SPAN when tracing is off); `cpu`
    records the thread's CPU time over it."""
    log = _logger or get_logger()
    if log._sink is None:
        return NO_SPAN
    return Span(log, name, parent, attrs, cpu)


def count(name: str, n: int = 1) -> None:
    """Add n to count `name` of the calling thread's innermost open span
    (nothing when tracing is off or no span is open)."""
    log = _logger or get_logger()
    if log._sink is None:
        return
    stack = log._thread().stack
    if stack:
        c = stack[-1].counts
        c[name] = c.get(name, 0) + n


def note(name: str, value: Any) -> None:
    """Set attr `name` of the calling thread's innermost open span to
    `value` (nothing when tracing is off or no span is open)."""
    log = _logger or get_logger()
    if log._sink is None:
        return
    stack = log._thread().stack
    if stack:
        stack[-1].attrs[name] = value


def stages(prefix: str, order: Sequence[str]):
    """Stages of `prefix` in `order`, or NO_SPAN when tracing is off."""
    log = _logger or get_logger()
    return NO_SPAN if log._sink is None else Stages(log, prefix, order)
