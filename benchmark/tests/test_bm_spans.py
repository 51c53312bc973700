"""The readers of the program's spans (metrics/_spans.py and the ten
metrics on it): a number from the records of a traced CPU run, the values
a hand-built record set implies, and None from a program without spans."""

import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.utils import log as L
from benchmark.harness.registry import Registry

NEW = {"encode.convert_ms", "encode.canny_ms", "encode.stage_a_wait_ms",
       "encode.hysteresis_checks", "decode.native_ms", "preview.edges_ms",
       "preview.plan_ms", "preview.blocks_ms", "preview.deflate_ms",
       "preview.syncs"}


def _read(name, events):
    return Registry().metric_reader(name)(SimpleNamespace(events=events))


@pytest.fixture(scope="module")
def traced_events():
    """The records of encode_stream, decode_stream and two preview
    requests on tiny images, traced on the CPU."""
    torch.set_num_threads(2)
    rng = np.random.default_rng(5)
    imgs = [at.ImageData.from_array(
        (rng.integers(0, 256, (32, 48, 3)) / 255.0).astype(np.float32),
        extension=".png") for _ in range(3)]
    cfg = at.CodecConfig("YCoCg", (20, 80), (4, 16))
    sink = io.StringIO()
    L._logger, before = L.StructuredLogger(sink), L._logger
    try:
        blobs = at.encode_stream(imgs, cfg, batch_size=2, device="cpu")
        at.decode_stream(blobs, batch_size=2, device="cpu")
        codec = at.Codec(cfg, device="cpu")
        for im in imgs[:2]:
            codec.decompress(codec.compress(im))
    finally:
        L._logger = before
    return [json.loads(line) for line in sink.getvalue().splitlines()]


def test_the_spec_lists_the_new_readers():
    """Each reader is in the spec under its own name or a cell's
    (`<reader>.<cell>`)."""
    spec = Registry().spec()["per_layer"]
    for name in NEW:
        entries = [m for m in spec if m["name"] == name
                   or m["name"].startswith(name + ".")]
        assert entries, name
        for m in entries:
            assert m["source"] in ("program_span", "program_counter")
            read = Registry().metric_reader(m["name"])
            assert read.__code__.co_filename == \
                Registry().metric_reader(name).__code__.co_filename


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_reads_a_traced_run(name, traced_events):
    value = _read(name, traced_events)
    assert isinstance(value, (int, float)) and value >= 0, value
    if name.endswith("_ms") or name.endswith("checks") \
            or name.endswith("syncs"):
        assert value > 0


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_finds_nothing_without_spans(name):
    parent_events = [
        {"event": "encode_batch", "ts": 2.0, "wall_s": 1.0,
         "stages": {"push": 0.5, "stage_a": 0.5}},
        {"event": "encode_stream", "ts": 2.0, "wall_s": 1.0, "images": 2}]
    assert _read(name, parent_events) is None
    assert _read(name, []) is None


def _span(i, name, parent, start, end, cpu=0, root=1, thread=7, **counts):
    return {"event": "span", "name": name, "id": i, "parent": parent,
            "root": root, "thread": thread, "start_ns": start * 10 ** 6,
            "end_ns": end * 10 ** 6, "cpu_ns": cpu * 10 ** 6,
            "counts": counts, "attrs": {}}


def test_readers_by_hand():
    """Two encode batches, medians of their values; one request."""
    ev = []
    for k, (conv, cpu, canny) in enumerate(((10, 5, 40), (20, 20, 60))):
        b = 100 * (k + 1)
        ev += [_span(b, "encode.batch", 1, b, b + 90),
               _span(b + 1, "encode.push", b, b, b + 30),
               _span(b + 2, "encode.convert", b + 1, b, b + conv, cpu),
               _span(b + 3, "encode.stage_a", b, b + 30, b + 90),
               _span(b + 4, "stage_a.canny", b + 3, b + 30, b + 30 + canny,
                     hysteresis_checks=k + 2),
               _span(b + 5, "sync.hysteresis", b + 4, b + 31, b + 33,
                     sync=1),
               _span(b + 6, "sync.levels", b + 3, b + 80, b + 84, sync=1)]
    ev += [_span(900, "codec.compress", None, 0, 50, root=900),
           _span(901, "encode.stage_a", 900, 0, 14, root=900),
           _span(902, "stage_a.canny", 901, 0, 10, root=900),
           _span(903, "sync.hysteresis", 902, 8, 10, root=900, sync=1),
           _span(904, "stage_a.canny", 901, 10, 13, root=900),
           _span(909, "encode.device", 900, 14, 16, root=900),
           _span(910, "encode.assemble", 900, 40, 50, root=900),
           _span(905, "codec.decompress", None, 51, 60, root=905),
           _span(906, "sync.upload", 905, 52, 53, root=905, sync=1),
           _span(907, "codec.decompress", None, 61, 70, root=907),
           _span(908, "sync.upload", 907, 62, 63, root=907, sync=1)]
    assert _read("encode.convert_ms", ev) == pytest.approx(15.0)
    assert _read("encode.canny_ms", ev) == pytest.approx(50.0)
    assert _read("encode.stage_a_wait_ms", ev) == pytest.approx(6.0)
    assert _read("encode.hysteresis_checks", ev) == pytest.approx(2.5)
    assert _read("preview.edges_ms", ev) == pytest.approx(13.0)
    assert _read("preview.blocks_ms", ev) == pytest.approx(2.0)
    assert _read("preview.deflate_ms", ev) == pytest.approx(10.0)
    assert _read("preview.syncs", ev) == 2
    assert _read("preview.plan_ms", ev) is None
