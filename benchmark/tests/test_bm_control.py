"""The comparison fails what it must: the reference computed at TF32 in
the codec's place (the control), and the timed path broken underneath a
run (half of each call's images left out, an answer altered where it is
produced).  The control is also run on the card at a cell's own size."""

import json
import time
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import aejpeg_tpu_torch as at
from benchmark import calibrate
from benchmark.harness import check
from benchmark.harness.main import run_cell
from benchmark.harness.registry import Registry

from .conftest import small_bench

CELLS = [w["name"] for w in Registry().spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, tmp_path):
    torch.set_num_threads(2)
    reg = small_bench(tmp_path, {"height": 128, "width": 192, "count": 3})
    prog, ctl = calibrate.readings(reg, cell, [21], [21], 1,
                                   torch.device("cpu"), at,
                                   emit=lambda line: None)
    limits = reg.limits(cell)
    assert check.verdict(prog[0], limits, prog[0]["failed"])
    assert not check.verdict(ctl[0], limits, ctl[0]["failed"])


def _plus_one(blob):
    """The container with every level of its first layer raised by one."""
    pos = 4 + int.from_bytes(blob[:4], "big")
    bits = int.from_bytes(blob[pos:pos + 4], "big")
    pos += 8 + (bits + 7) // 8
    clen = int.from_bytes(blob[pos:pos + 4], "big")
    raw = np.frombuffer(zlib.decompress(blob[pos + 4:pos + 4 + clen]),
                        "<i4") + 1
    comp = zlib.compress(raw.astype("<i4").tobytes())
    return (blob[:pos] + len(comp).to_bytes(4, "big") + comp
            + blob[pos + 4 + clen:])


def _brighter(img):
    data = img.data.copy()
    data[..., 0] += np.float32(1 / 255)
    return at.ImageData(data, img.original_shape, img.extension)


def _one_block(img):
    """The image with one 4x4 block of its first channel raised by 0.05:
    far under 1% of its values."""
    data = img.data.copy()
    data[4:8, 4:8, 0] += np.float32(0.05)
    return at.ImageData(data, img.original_shape, img.extension)


def _half(fn):
    """Each call's first half of the inputs done, the rest answered with
    the first half's answers."""
    def run(items, *a, **kw):
        done = fn(items[:(len(items) + 1) // 2], *a, **kw)
        return [done[i % len(done)] for i in range(len(items))]
    return run


def _altered(fn, alter):
    def run(*a, **kw):
        return [alter(o) for o in fn(*a, **kw)]
    return run


class _AlteredCodec(at.Codec):
    def compress(self, img):
        return _plus_one(super().compress(img))

    def decompress(self, data):
        return _brighter(super().decompress(data))


class _BlockCodec(at.Codec):
    def decompress(self, data):
        return _one_block(super().decompress(data))


def _program(fault):
    p = SimpleNamespace(CodecConfig=at.CodecConfig, ImageData=at.ImageData,
                        Codec=at.Codec, encode_stream=at.encode_stream,
                        decode_stream=at.decode_stream)
    if fault == "half":
        p.encode_stream = _half(at.encode_stream)
        p.decode_stream = _half(at.decode_stream)
    elif fault == "block":
        p.decode_stream = _altered(at.decode_stream, _one_block)
        p.Codec = _BlockCodec
    else:
        p.encode_stream = _altered(at.encode_stream, _plus_one)
        p.decode_stream = _altered(at.decode_stream, _brighter)
        p.Codec = _AlteredCodec
    return p


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in ("half", "altered", "block")
    if not (c == "kodak.preview" and f == "half")
    and not (f == "block" and "image" not in Registry().kind(
        Registry().traffic(Registry().workload(c)["traffic"])["kind"])
        .produces)])
def test_broken_timed_path_is_not_correct(cell, fault, tmp_path, capsys):
    torch.set_num_threads(2)
    reg = small_bench(tmp_path)
    for f in (tmp_path / "benchmark" / "traffic").iterdir():
        t = json.loads(f.read_text())
        t.update(sample=3)
        if "repeat" in t:
            t.update(repeat=1)
        f.write_text(json.dumps(t))
    rc = run_cell(reg, cell, 3, 0.2, False, time.perf_counter(),
                  device=torch.device("cpu"), program=_program(fault),
                  look_for_chip=False)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is False


def test_sound_run_is_correct(tmp_path, capsys):
    torch.set_num_threads(2)
    reg = small_bench(tmp_path)
    rc = run_cell(reg, "clic.encode-stream", 3, 0.2, False,
                  time.perf_counter(), device=torch.device("cpu"),
                  look_for_chip=False)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True and res["failed"] == 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, card):
    """At the cell's own size, one seed: the control fails, the program
    passes (calibrate.py reads a dozen seeds for the limits)."""
    reg = Registry()
    prog, ctl = calibrate.readings(reg, cell, [31], [31], 1, card, at,
                                   emit=lambda line: None)
    limits = reg.limits(cell)
    assert check.verdict(prog[0], limits, prog[0]["failed"])
    assert not check.verdict(ctl[0], limits, ctl[0]["failed"])
