"""encode_batch's push on the card's route, held on the CPU to the host's
route: f32_to_unit's plain version against _host_batch + u8_to_unit, the
exact/float decision, the staging copy at any thread count, the kernel
wrapper's launch, and the containers and spans of the route (forced onto
the CPU, with a plain buffer in place of the pinned one) against the host
route's."""

import io
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.codec import batch_encode as be
from aejpeg_tpu_torch.ops import kernels as K
from aejpeg_tpu_torch.utils import log as L

torch.set_num_threads(1)

KINDS = ("marked", "unmarked", "half", "tiny", "nan", "range", "mixed")
SHAPES = ((37, 53, 1), (37, 53, 3), (1, 1, 1), (1, 1, 3), (512, 768, 1),
          (512, 768, 3))


def _images(kind, h, w, n, seed=0):
    """n images of k/255 values; `kind` marks them (loader's u8_exact) or
    not, and puts a value that is no k/255 (0.5, 1e-9, NaN, -0.25 and 1.5)
    into the last one; "mixed": all but the last marked, the last holding
    0.5."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    data = data.astype(np.float32) / 255.0
    last = data[-1].reshape(-1)
    if kind in ("half", "mixed"):
        last[last.size // 2] = 0.5
    elif kind == "tiny":
        last[0] = 1e-9
    elif kind == "nan":
        last[-1] = np.nan
    elif kind == "range":
        last[0] = -0.25
        last[-1] = 1.5
    imgs = [at.ImageData.from_array(d, extension=".png") for d in data]
    for i, im in enumerate(imgs):
        im.u8_exact = (kind == "marked" or (kind == "mixed" and i < n - 1)
                       or None)
    return imgs


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.filterwarnings("ignore:invalid value encountered in cast")
@pytest.mark.parametrize("h,w,n", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_unit_batch_matches_host_batch(kind, h, w, n):
    """The plain version's unit floats equal u8_to_unit of _host_batch's
    uint8 bit for bit wherever that is exact, its flags say which
    unmarked image is not, and the route hands stage A what _host_batch
    does: the unit floats (tiny False) or the float32 as it is."""
    imgs = _images(kind, h, w, n)
    host = be._host_batch(imgs)
    x = torch.from_numpy(np.stack([im.data for im in imgs]))
    unit, flags = K.f32_to_unit_plain(x, check=True)
    for i, im in enumerate(imgs):
        exact = be._host_batch([im]).dtype == np.uint8
        assert flags[i].item() == (not exact)
        if exact:
            want = K.u8_to_unit_plain(torch.from_numpy(be._host_batch([im])))
            assert torch.equal(_bits(unit[i]), _bits(want[0]))
    got, tiny = be._unit_batch(x.clone(), imgs)
    if host.dtype == np.uint8:
        assert tiny is False
        assert torch.equal(_bits(got),
                           _bits(K.u8_to_unit_plain(torch.from_numpy(host))))
    else:
        assert tiny is True
        assert torch.equal(_bits(got), _bits(torch.from_numpy(host)))


# products at k + 1/2 exactly (k = 0, 2, 254: half to even rounds down)
HALVES = [float(np.float32((k + 0.5) / 255)) for k in (0, 2, 254)]


@pytest.mark.parametrize("value", [0.0, -0.0, 1.0, 0.5, 1e-9, 1e-40, -1e-9,
                                   255.5 / 255, 1.0000001, 300.0, -3.0,
                                   np.inf, -np.inf, np.nan] + HALVES)
def test_plain_rounds_as_numpy(value):
    """Every special value: k = rint(x * 255) clamped to [0, 255], NaN at 0,
    half to even, and the flag is numpy's array_equal of the round trip."""
    x = torch.full((1, 2, 2, 3), value, dtype=torch.float32)
    x[0, 0, 0, 0] = 0.2
    unit, flags = K.f32_to_unit_plain(x, check=True)
    r = np.rint(np.multiply(np.float32(value), np.float32(255)))
    if value in HALVES:
        assert r % 2 == 0 and r + 0.5 == np.float32(value) * np.float32(255)
    k = 0 if np.isnan(r) else int(np.clip(r, 0, 255))
    assert unit[0, 1, 1, 2].item() == np.float32(k) / np.float32(255)
    with np.errstate(invalid="ignore"):
        im = at.ImageData.from_array(x[0].numpy())
        exact = be._host_batch([im]).dtype == np.uint8
    assert flags.tolist() == [int(not exact)]


@pytest.mark.parametrize("threads", [1, 2, 7, 200])
def test_stage_images_any_thread_count(threads):
    """The staging copy writes np.stack's bytes, whatever the runs."""
    imgs = _images("unmarked", 37, 53, 5, seed=threads)
    out = np.full((5, 37, 53, 3), np.nan, np.float32)
    be.stage_images(imgs, out, threads)
    assert out.tobytes() == np.stack([im.data for im in imgs]).tobytes()


def test_stage_images_concurrent_callers():
    """More callers than cores share the one pool at once (as the streams'
    workers do), with a short switch interval: each buffer gets its own
    images' bytes."""
    n_callers = 2 * len(os.sched_getaffinity(0)) + 2
    imgs = [_images("unmarked", 23, 31, 3, seed=i) for i in range(n_callers)]
    outs = [np.zeros((3, 23, 31, 3), np.float32) for _ in imgs]
    errors = []

    def caller(i):
        try:
            for _ in range(20):
                outs[i][:] = 0
                be.stage_images(imgs[i], outs[i], 5)
                if outs[i].tobytes() != np.stack(
                        [im.data for im in imgs[i]]).tobytes():
                    errors.append(i)
        except Exception as e:             # reported below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(n_callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_f32_to_unit_card_launch(monkeypatch):
    """The card's route of the wrapper, launch stubbed: in place without
    flags, a new output and zeroed (B,) flags with check; n, the
    elements an image, and one launch counted each."""
    calls = []
    monkeypatch.setattr(K, "_route", lambda name, dev: True)
    monkeypatch.setattr(K, "_launch",
                        lambda name, dev, *a: calls.append((name, a)))
    x = torch.rand((3, 5, 7, 3))
    before = K.LAUNCHES["f32_to_unit"].n
    out, flags = K.f32_to_unit(x, out=x)
    assert out is x and flags is None
    (name, (src, dst, table, fl, n, per)), = calls
    assert name == "aej_f32_to_unit"
    assert (src, dst, fl, n, per) == (x.data_ptr(), x.data_ptr(), None,
                                      315, 105)
    out, flags = K.f32_to_unit(x, check=True)
    assert out.data_ptr() != x.data_ptr()
    assert flags.dtype == torch.int32 and flags.tolist() == [0, 0, 0]
    assert calls[1][1][3] == flags.data_ptr()
    assert K.LAUNCHES["f32_to_unit"].n == before + 2
    with pytest.raises(TypeError):
        K.f32_to_unit(x.double())
    with pytest.raises(ValueError):
        K.f32_to_unit(x.transpose(1, 2))


def test_f32_to_unit_cpu_in_place():
    x = torch.from_numpy(np.stack([im.data for im in
                                   _images("half", 9, 11, 2)]))
    want, _ = K.f32_to_unit_plain(x)
    out, flags = K.f32_to_unit(x, out=x)
    assert out is x and flags is None
    assert torch.equal(_bits(x), _bits(want))


def _card_route(m):
    """The card's route of encode_batch on the CPU: a plain buffer for the
    pinned one (a CPU-only build has no pinned allocator)."""
    m.setattr(be, "_pinned_route", lambda dev, images: True)
    m.setattr(be, "pinned_buffer",
              lambda key, nbytes, dtype: torch.empty(
                  nbytes, dtype=torch.uint8).view(dtype))


@pytest.fixture
def card_route(monkeypatch):
    _card_route(monkeypatch)


@pytest.mark.parametrize("kind", ["marked", "unmarked", "half"])
@pytest.mark.parametrize("level", [9, 6, -1])
def test_card_route_containers(monkeypatch, level, kind):
    """The route's containers, byte-identical to the host route's, at
    levels 9, 6 and -1, on marked, unmarked exact and inexact images."""
    cfg = at.CodecConfig("YCoCg", (20, 80), (4, 32), entropy_level=level)
    imgs = _images(kind, 48, 80, 2, seed=level + 10)
    want = at.encode_batch(imgs, cfg, device="cpu")
    with monkeypatch.context() as m:
        _card_route(m)
        m.setattr(be, "POOL_MIN_BYTES", 0)         # the pool's runs
        got = at.encode_batch(imgs, cfg, device="cpu")
    assert got == want


def _traced_push(monkeypatch, imgs):
    sink = io.StringIO()
    monkeypatch.setattr(L, "_logger", L.StructuredLogger(sink))
    try:
        at.encode_batch(imgs, at.CodecConfig("YCoCg", (20, 80), (4, 16)),
                        device="cpu")
    finally:
        L.configure(None)
    spans = [json.loads(x) for x in sink.getvalue().splitlines()]
    by = {s["name"]: s for s in spans}
    push, stage_a = by["encode.push"], by["encode.stage_a"]
    kids = {s["name"] for s in spans if s["parent"] == push["id"]}
    a_kids = {s["name"] for s in spans if s["parent"] == stage_a["id"]}
    return by["encode.convert"], kids, a_kids


@pytest.mark.parametrize("kind,checks", [("marked", 0), ("half", 1)])
def test_card_route_spans(monkeypatch, card_route, kind, checks):
    """encode.push holds encode.convert (route pinned, threads, the count
    push_exact_checks) and encode.upload, which does not wait; a batch
    with unmarked images pulls its flags in sync.exact in stage A."""
    conv, kids, a_kids = _traced_push(monkeypatch,
                                      _images(kind, 32, 48, 2))
    assert kids == {"encode.convert", "encode.upload"}
    assert conv["attrs"] == {"route": "pinned", "threads": 1}
    assert conv["counts"] == {"push_exact_checks": checks}
    assert conv["cpu_ns"] is not None
    assert ("sync.exact" in a_kids) == bool(checks)


def test_card_route_pool_threads(monkeypatch, card_route):
    monkeypatch.setattr(be, "POOL_MIN_BYTES", 0)
    conv, _, _ = _traced_push(monkeypatch, _images("marked", 32, 48, 2))
    assert conv["attrs"] == {"route": "pinned",
                             "threads": len(os.sched_getaffinity(0))}


def test_host_route_spans(monkeypatch):
    """The CPU device keeps _host_batch: route host, one thread, the
    blocking upload."""
    conv, kids, _ = _traced_push(monkeypatch, _images("marked", 32, 48, 2))
    assert kids == {"encode.convert", "sync.upload"}
    assert conv["attrs"] == {"route": "host", "threads": 1}
    assert conv["counts"] == {}
