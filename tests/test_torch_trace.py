"""The port's tracer (aejpeg_tpu_torch/utils/log.py) on the CPU, on tiny
images: off it is inert; on, spans nest across the streams' worker
threads, counts land on the innermost span, records are written once per
root, the batch events keep what the benchmark reads, the per-image Codec
emits its spans, and a span's start lies on the profiler's clock."""

import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.utils import log as L
from benchmark.harness.registry import Registry
from benchmark.harness.trace import stage_intervals

torch.set_num_threads(1)

H, W = 32, 48
CFG = at.CodecConfig("YCoCg", (20, 80), (4, 16))
ENCODE = ("push", "stage_a", "plans", "device", "pull", "assemble")
DECODE = ("parse", "push", "device", "pull")


def _images(n):
    rng = np.random.default_rng(3)
    return [at.ImageData.from_array(
        (rng.integers(0, 256, (H, W, 3)) / 255.0).astype(np.float32),
        extension=".png") for _ in range(n)]


class Sink(io.StringIO):
    """A sink that counts its writes."""
    writes = 0

    def write(self, text):
        self.writes += 1
        return super().write(text)


@pytest.fixture
def traced(monkeypatch):
    """Tracing on into an in-memory sink for the test; off after it."""
    sink = Sink()
    monkeypatch.setattr(L, "_logger", L.StructuredLogger(sink))
    yield sink
    L.configure(None)


def _records(sink):
    return [json.loads(line) for line in sink.getvalue().splitlines()]


def _spans(recs):
    return {r["id"]: r for r in recs if r["event"] == "span"}


def _kids(spans, rec, name=None):
    return [s for s in spans.values() if s["parent"] == rec["id"]
            and (name is None or s["name"] == name)]


class _NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"the tracer read time.{name} while off")


def test_off_is_inert(monkeypatch, capsys):
    L.configure(None)
    entered = []
    monkeypatch.setattr(L, "record_function",
                        lambda name: entered.append(name))
    monkeypatch.setattr(L, "time", _NoClock())
    with L.span("x", batch=1) as s, L.stages("y", ("a", "b")) as st:
        L.count("n", 3)
        st.mark("a")
    assert s is L.NO_SPAN and st is L.NO_SPAN
    blobs = at.encode_stream(_images(2), CFG, batch_size=1, lookahead=2,
                             device="cpu")
    at.decode_stream(blobs, batch_size=1, device="cpu")
    codec = at.Codec(CFG, device="cpu")
    codec.decompress(codec.compress(_images(1)[0]))
    assert entered == []
    out = capsys.readouterr()
    assert out.out == "" and out.err == ""


def test_spans_nest_across_threads(traced):
    at.encode_stream(_images(4), CFG, batch_size=1, lookahead=2,
                     device="cpu")
    spans = _spans(_records(traced))
    roots = [s for s in spans.values() if s["parent"] is None]
    assert [r["name"] for r in roots] == ["encode_stream"]
    root = roots[0]
    assert root["attrs"] == {"images": 4, "batches": 4,
                             "mpix": round(4 * H * W / 1e6, 3)}
    assert all(s["root"] == root["id"] for s in spans.values())
    batches = _kids(spans, root)
    assert sorted(b["attrs"]["batch"] for b in batches) == [0, 1, 2, 3]
    assert {b["name"] for b in batches} == {"encode.batch"}
    assert all(b["thread"] != root["thread"] for b in batches)
    for b in batches:
        stages = {s["name"]: s for s in _kids(spans, b)}
        assert set(stages) == {f"encode.{n}" for n in ENCODE}
        assert {s["name"] for s in _kids(spans, stages["encode.push"])} \
            == {"encode.convert", "sync.upload"}
        stage_a = stages["encode.stage_a"]
        assert {s["name"] for s in _kids(spans, stage_a)} \
            == {"stage_a.canny", "sync.levels"}
        assert {s["name"] for s in _kids(spans, stages["encode.assemble"])} \
            == {"assemble.native", "assemble.containers"}
        cannies = _kids(spans, stage_a, "stage_a.canny")
        assert len(cannies) == 2                    # luma, then chroma
        for c in cannies:
            checks = _kids(spans, c, "sync.hysteresis")
            assert checks and c["counts"] == {
                "hysteresis_checks": len(checks),
                "hysteresis_steps": 8 * len(checks)}
    for s in spans.values():
        assert s["start_ns"] <= s["end_ns"]
        assert (s["cpu_ns"] is None) == (s["name"] != "encode.convert")
        assert s["counts"].get("sync", 0) == s["name"].startswith("sync.")
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
            if p is not root:
                assert s["thread"] == p["thread"]


def test_counts_land_on_the_innermost_span(traced):
    L.count("dropped")                       # no span open: nothing
    with L.span("outer") as outer:
        L.count("a")
        with L.span("inner"):
            L.count("a", 2)
            L.count("b")
        with L.stages("st", ("one", "two", "three")) as st:
            L.count("c")
            st.mark("one")
            L.count("d")
            st.mark("two")
            L.count("e")                     # on "st.three", never reached
    spans = {s["name"]: s for s in _spans(_records(traced)).values()}
    assert set(spans) == {"outer", "inner", "st.one", "st.two"}
    assert spans["outer"]["counts"] == {"a": 1}
    assert spans["inner"]["counts"] == {"a": 2, "b": 1}
    assert spans["st.one"]["counts"] == {"c": 1}
    assert spans["st.two"]["counts"] == {"d": 1}
    assert spans["st.one"]["parent"] == outer.id
    assert spans["st.one"]["end_ns"] <= spans["st.two"]["start_ns"]


def test_records_written_once_per_root(traced):
    blobs = at.encode_stream(_images(3), CFG, batch_size=2, device="cpu")
    codec = at.Codec(CFG, device="cpu")
    codec.decompress(blobs[0])
    assert traced.writes == 2
    codec.compress(_images(1)[0])
    assert traced.writes == 3
    recs = _records(traced)
    ids = [r["id"] for r in recs if r["event"] == "span"]
    assert len(ids) == len(set(ids))
    roots = [r["name"] for r in recs if r["event"] == "span"
             and r["parent"] is None]
    assert roots == ["encode_stream", "codec.decompress", "codec.compress"]
    # each root's records form one write, the root's own record last
    lines = traced.getvalue().splitlines()
    assert json.loads(lines[-1])["name"] == "codec.compress"
    with L.span("left-open"):
        with L.span("waiting"):
            pass
        L.get_logger().flush()               # as configure() and exit do
        assert json.loads(traced.getvalue().splitlines()[-1])["name"] \
            == "waiting"
    assert traced.writes == 5


def test_batch_events_keep_what_the_benchmark_reads(traced):
    blobs = at.encode_stream(_images(3), CFG, batch_size=2, device="cpu")
    at.decode_stream(blobs, batch_size=2, device="cpu")
    recs = _records(traced)
    spans = _spans(recs)
    assert not any("mpix_per_s" in r for r in recs)
    assert {r["event"] for r in recs} == {"span", "encode_batch",
                                          "decode_batch"}
    for event, stage_names, batch in (("encode_batch", ENCODE,
                                       "encode.batch"),
                                      ("decode_batch", DECODE,
                                       "decode.batch")):
        evs = [r for r in recs if r["event"] == event]
        assert sorted(e["images"] for e in evs) == [1, 2]
        bspans = {s["attrs"]["batch"]: s for s in spans.values()
                  if s["name"] == batch}
        for e in evs:
            keys = {"ts", "logger", "event", "batch", "images", "mpix",
                    "wall_s", "stages"} | ({"bytes"} if event[0] == "e"
                                           else set())
            assert set(e) == keys
            assert tuple(e["stages"]) == stage_names
            b = bspans[e["batch"]]
            assert e["ts"] == pytest.approx(b["end_ns"] / 1e9, abs=1e-6)
            assert e["wall_s"] == pytest.approx(
                (b["end_ns"] - b["start_ns"]) / 1e9, abs=1e-6)
            # the harness's stage intervals lie in the batch span, and
            # each is its stage span within scheduling noise
            prefix = batch.split(".")[0]
            kids = {s["name"]: s for s in _kids(spans, b)}
            for name, a, z in stage_intervals([e], {event: prefix}):
                assert b["start_ns"] / 1e9 - 1e-3 <= a <= z \
                    <= b["end_ns"] / 1e9 + 1e-6
                s = kids[name]
                assert (s["end_ns"] - s["start_ns"]) / 1e9 \
                    == pytest.approx(z - a, abs=0.05)
    reg = Registry()
    ctx = SimpleNamespace(events=recs)
    for name in ("encode.push_ms", "encode.stage_a_ms", "encode.assemble_ms",
                 "decode.parse_ms", "decode.stage_d_ms"):
        assert reg.metric_reader(name)(ctx) > 0, name


def test_codec_emits_its_spans(traced):
    """The Codec's two roots hold encode_batch's and decode_batch's stage
    spans, in order, with their syncs."""
    codec = at.Codec(at.CodecConfig("YCoCg", (40, 80), (4, 16)),
                     device="cpu")
    codec.decompress(codec.compress(_images(1)[0]))
    recs = _records(traced)
    assert {r["event"] for r in recs} == {"span"}
    spans = _spans(recs)
    comp, dec = sorted((s for s in spans.values() if s["parent"] is None),
                       key=lambda s: s["start_ns"])
    assert (comp["name"], dec["name"]) == ("codec.compress",
                                           "codec.decompress")
    for root, prefix, order in ((comp, "encode", ENCODE),
                                (dec, "decode", DECODE)):
        kids = sorted(_kids(spans, root), key=lambda s: s["start_ns"])
        assert [s["name"] for s in kids] == [f"{prefix}.{n}"
                                             for n in order]
        assert all(s["root"] == root["id"] for s in spans.values()
                   if s["start_ns"] >= root["start_ns"]
                   and s["end_ns"] <= root["end_ns"])
    stage = {s["name"]: s for s in _kids(spans, comp)}
    assert {s["name"] for s in _kids(spans, stage["encode.push"])} == {
        "encode.convert", "sync.upload"}
    assert {s["name"] for s in _kids(spans, stage["encode.stage_a"])} == {
        "stage_a.canny", "sync.levels"}
    for c in _kids(spans, stage["encode.stage_a"], "stage_a.canny"):
        assert c["counts"]["hysteresis_checks"] == len(
            _kids(spans, c, "sync.hysteresis")) >= 1
    assert {s["name"] for s in _kids(spans, stage["encode.assemble"])} == {
        "assemble.native", "assemble.containers"}
    stage = {s["name"]: s for s in _kids(spans, dec)}
    assert _kids(spans, stage["decode.push"], "sync.upload")
    assert _kids(spans, stage["decode.pull"], "sync.pull")
    assert not any(s["name"].startswith("codec.") for s in spans.values()
                   if s["parent"] is not None)


def test_span_start_on_the_profilers_clock(traced, tmp_path, monkeypatch):
    """A span enters its record_function range while a profiler records
    its thread, and only then; the range starts where the span does."""
    from torch.profiler import ProfilerActivity, profile
    entered = []
    real = L.record_function
    monkeypatch.setattr(L, "record_function",
                        lambda name: entered.append(name) or real(name))
    with L.span("no.profiler"):
        pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with L.span("clock.probe"):
            torch.ones(8).sum()
    assert entered == ["clock.probe"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    rng = [e for e in trace["traceEvents"] if e.get("name") == "clock.probe"
           and e.get("ph") == "X"]
    span = next(s for s in _spans(_records(traced)).values()
                if s["name"] == "clock.probe")
    assert len(rng) == 1
    at_ns = rng[0]["ts"] * 1e3 + trace["baseTimeNanoseconds"]
    assert abs(at_ns - span["start_ns"]) < 1e6
    assert rng[0]["tid"] == span["thread"]


@pytest.mark.parametrize("mesh", [False, True], ids=["device", "mesh"])
def test_stage_spans_are_the_timed_stages(traced, mesh):
    """On one device and on a mesh, encode_batch's and decode_batch's
    stage spans are the stages their timings= name, in order."""
    from aejpeg_tpu_torch.parallel import make_mesh
    kw = ({"mesh": make_mesh((2, 1), devices=["cpu"] * 2)} if mesh
          else {"device": "cpu"})
    enc, dec = {}, {}
    blobs = at.encode_batch(_images(2), CFG, timings=enc, **kw)
    at.decode_batch(blobs, timings=dec, **kw)
    spans = sorted((s for s in _records(traced) if s["event"] == "span"
                    and s["parent"] is None), key=lambda s: s["start_ns"])
    assert [s["name"] for s in spans] == [f"encode.{k}" for k in enc] \
        + [f"decode.{k}" for k in dec]


def test_threads_share_one_root_without_losing_records(traced):
    """More threads than cores, switching as often as the interpreter
    allows: every span of every thread is written once, under the root,
    with its own counts."""
    import os
    import sys
    import threading
    n_threads, n_spans = 2 * (os.cpu_count() or 2) + 2, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with L.span("stress") as root:
            def work(k):
                with L.span("worker", parent=root, k=k):
                    for _ in range(n_spans):
                        with L.span("leaf"):
                            L.count("n", k + 1)
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = _spans(_records(traced))
    assert traced.writes == 1
    assert len(spans) == 1 + n_threads * (1 + n_spans)
    workers = {s["id"]: s for s in spans.values() if s["name"] == "worker"}
    assert all(w["parent"] == root.id for w in workers.values())
    for s in spans.values():
        assert s["root"] == root.id
        if s["name"] == "leaf":
            w = workers[s["parent"]]
            assert s["counts"] == {"n": w["attrs"]["k"] + 1}
            assert s["thread"] == w["thread"]
