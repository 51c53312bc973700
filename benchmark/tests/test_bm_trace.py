"""Device busy time as a union of intervals, idle gaps named by host
stages, the Chrome-trace reader, and the rooflines' work formulas against
hand counts."""

import json
from types import SimpleNamespace

import pytest

from benchmark.harness import readers, trace
from benchmark.harness.registry import Registry


def test_union_counts_overlap_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert trace.union(iv) == [(0.0, 3.0), (5.0, 6.0)]
    assert trace.busy(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert trace.busy(iv, 2.5, 5.5) == pytest.approx(1.0)
    assert trace.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]


def test_idle_gaps_named_by_stage():
    iv = [(0.0, 1.0), (2.0, 3.0), (3.5, 4.0)]
    stages = [("encode.push", 0.5, 2.5), ("encode.assemble", 3.2, 3.6),
              ("encode.push", 3.0, 3.4)]
    by = trace.idle_by_stage(iv, 0.0, 5.0, stages)
    assert by == pytest.approx({"encode.push": 1.0,
                                "encode.assemble+encode.push": 0.5,
                                "between stages": 1.0})


def test_stage_intervals_from_events():
    ev = [{"event": "encode_batch", "ts": 10.0, "wall_s": 3.0,
           "stages": {"push": 1.0, "stage_a": 2.0}},
          {"event": "encode_stream", "ts": 11.0, "wall_s": 5.0}]
    assert trace.stage_intervals(ev, {"encode_batch": "encode"}) == [
        ("encode.push", 7.0, 8.0), ("encode.stage_a", 8.0, 10.0)]


def test_chrome_trace(tmp_path):
    ev = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": trace.MARK_START,
         "ts": 1000.0, "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "void dct2d_kernel<4, 4>()",
         "ts": 1100.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 1250.0,
         "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 1500.0, "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1000.0,
         "dur": 900.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": trace.MARK_END,
         "ts": 1.0, "dur": 1.0},
        {"ph": "X", "cat": "user_annotation", "name": trace.MARK_END,
         "ts": 2000.0, "dur": 1.0}]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(ev))
    t = trace.from_chrome(str(path), host_mark=50.0)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(300e-6)
    assert t.time_of(("dct2d_kernel",)) == (pytest.approx(200e-6), 1)
    assert t.top_ops(2)[0] == ["void dct2d_kernel<4, 4>()",
                               pytest.approx(200e-6)]
    assert t.ops[0][1] == pytest.approx(50.0 + 100e-6)


def _ctx(ops, leaves, count=3):
    cfg = Registry().config("live-ycocg-q20-80-b4-128")
    cfg["images"].update(height=64, width=96, count=count)
    return SimpleNamespace(
        config=cfg, work={"calls": 2, "repeat": 1, "leaves": leaves},
        trace=trace.DeviceTrace(ops, 0.0, 1.0),
        peaks={"bytes_per_s": 1e9, "fp32_per_s": 1e9}, log=lambda *a: None,
        metric="dct2d_roofline.encode")


def _reader(name):
    return Registry().metric_reader(name)


def test_dct_roofline_hand_count():
    ctx = _ctx([("void dct2d_kernel<4, 4>(float const*)", 0.0, 1e-3),
                ("void dct2d_kernel<8, 2>(float const*)", 0.5, 0.501),
                ("other", 0.0, 0.5)],
               {0: {4: 10, 8: 2}, 1: {4: 6}, 2: {}})
    # layers 64x96, 32x48, 32x48: 9216 pixels an image, 3 images, 2 calls
    nbytes = 2 * (4 * 9216 * 3 + 2 * (10 * 16 + 2 * 64 + 6 * 16))
    flops = 2 * 4 * (10 * 64 + 2 * 512 + 6 * 64)
    least = max(nbytes, flops) / 1e9
    got = _reader("dct2d_roofline.encode")(ctx)
    assert got == pytest.approx(100 * least / 2e-3)


def test_bilateral_roofline_hand_count():
    ctx = _ctx([("void bilateral_kernel<2>(unsigned char const*)", 0.0,
                 1e-3)], {0: {}})
    pixels = 2 * 3 * 9216
    least = max(2 * pixels, 53 * pixels) / 1e9
    got = _reader("bilateral_roofline")(ctx)
    assert got == pytest.approx(100 * least / 1e-3)


def test_readers_find_nothing_without_a_trace():
    ctx = _ctx([], {0: {4: 1}})
    ctx.trace = None
    for name in ("dct2d_roofline.encode", "dct2d_roofline.decode",
                 "bilateral_roofline", "idle_share.encode"):
        assert _reader(name)(ctx) is None


def test_idle_share():
    ctx = _ctx([("k", 0.1, 0.3), ("k", 0.2, 0.4)], {})
    assert readers.idle_share(ctx) == pytest.approx(70.0)
