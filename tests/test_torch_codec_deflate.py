"""The per-image `Codec` deflates each layer on a pool thread as soon as the
layer is packed: the same container bytes as deflating the layers one
after another, one `codec.deflate` span on the request's thread, and no
deflate left running when a layer fails."""

import io
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.codec import pipeline
from aejpeg_tpu_torch.io.container import ContainerReader, ContainerWriter
from aejpeg_tpu_torch.native import deflate_parallel
from aejpeg_tpu_torch.native.entropy import DEFAULT_CHUNK
from aejpeg_tpu_torch.utils import log as L
from benchmark.harness.registry import Registry

torch.set_num_threads(2)


def _image(h, w, seed=0):
    """A u8-exact RGB image: gradients, a hard-edged block, noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(x / 9.0) * np.cos(y / 13.0),
                    (x + y) / (h + w), 0.5 + 0.3 * np.cos(x / 5.0)], -1)
    img[h // 4:h // 2, w // 3:2 * w // 3] = rng.random(3)
    img += rng.normal(0, 0.03, img.shape)
    return at.ImageData.from_array(
        (np.round(np.clip(img, 0, 1) * 255) / 255).astype(np.float32),
        extension=".png")


def _config(level):
    return at.CodecConfig("YCoCg", (40, 80), (4, 64), entropy_level=level)


def _sequential(blob, level):
    """The container rebuilt from `blob`'s layers, each deflated in turn
    by the writer, as the `Codec` wrote it before its deflate pool."""
    reader = ContainerReader(blob)
    writer = ContainerWriter(
        reader.metadata, compress=lambda b: deflate_parallel(b, level=level))
    layers = reader.read_layers()
    for layer in layers:
        layer.compressed = None
        writer.add_layer(layer)
    return writer.tobytes(), layers


@pytest.mark.parametrize("shape", [(512, 768), (37, 53)],
                         ids=["512x768", "37x53"])
@pytest.mark.parametrize("level", [9, 6, -1])
def test_pool_writes_the_sequential_bytes(level, shape):
    blob = at.Codec(_config(level), device="cpu").compress(_image(*shape))
    want, layers = _sequential(blob, level)
    assert blob == want
    if shape == (512, 768):     # luma's stream spans two chunks
        assert layers[0].coeffs.nbytes > DEFAULT_CHUNK


@pytest.fixture
def sink():
    """Tracing on, into a string, for the test's span records."""
    out = io.StringIO()
    L._logger, before = L.StructuredLogger(out), L._logger
    try:
        yield out
    finally:
        L._logger = before


def _records(out):
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_traced_compress_deflates_every_layer_ahead(sink):
    codec = at.Codec(_config(9), device="cpu")
    codec.compress(_image(37, 53))
    spans = [r for r in _records(sink) if r["event"] == "span"]
    comp = next(s for s in spans if s["name"] == "codec.compress")
    assert comp["counts"]["deflate_ahead"] == 3
    deflates = [s for s in spans if s["name"] == "codec.deflate"]
    assert len(deflates) == 1
    assert deflates[0]["parent"] == comp["id"]
    # the pool's threads open no span: every span is the request's
    assert {s["thread"] for s in spans} == {threading.get_native_id()}


def test_deflate_ahead_reader():
    """`preview.deflate_ahead` reads the count a request; nothing from a
    program without it."""
    read = Registry().metric_reader("preview.deflate_ahead")

    def comp(i, **counts):
        return {"event": "span", "name": "codec.compress", "id": i,
                "parent": None, "root": i, "thread": 7, "start_ns": i,
                "end_ns": i + 1, "cpu_ns": None, "counts": counts,
                "attrs": {}}

    assert read(SimpleNamespace(events=[comp(1, deflate_ahead=3),
                                        comp(5, deflate_ahead=3),
                                        comp(9, deflate_ahead=1)])) == 3
    assert read(SimpleNamespace(events=[comp(1, sync=2)])) is None
    assert read(SimpleNamespace(events=[])) is None


def test_failed_layer_leaves_no_deflate_running(monkeypatch):
    """An edge map that raises on the third layer: compress raises with no
    deflate running, and the same Codec's next compress writes the
    sequential bytes."""
    live = {"now": 0, "started": 0, "ended": 0}
    lock = threading.Lock()
    real = pipeline.deflate_parallel

    def slow_deflate(data, level):
        with lock:
            live["now"] += 1
            live["started"] += 1
        try:
            time.sleep(0.2)
            return real(data, level=level)
        finally:
            with lock:
                live["now"] -= 1
                live["ended"] += 1

    monkeypatch.setattr(pipeline, "deflate_parallel", slow_deflate)
    calls = []

    def edges(layer):
        calls.append(layer.shape)
        if len(calls) == 3:
            raise RuntimeError("edge map failed")
        return pipeline._canny_plane(layer)

    img = _image(64, 96)
    codec = at.Codec(_config(9), edge_fn=edges, device="cpu")
    with pytest.raises(RuntimeError, match="edge map failed"):
        codec.compress(img)
    # each of the two deflates submitted ran to its end or was cancelled
    # before it began, and none starts later
    started = live["started"]
    assert 1 <= started <= 2 and live["now"] == 0
    time.sleep(0.3)
    assert live == {"now": 0, "started": started, "ended": started}
    blob = codec.compress(img)
    assert live["now"] == 0 and live["started"] == started + 3
    assert blob == _sequential(blob, 9)[0]
    assert blob == at.Codec(_config(9), device="cpu").compress(img)
