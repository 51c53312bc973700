"""The CLIC deployment (benchmark/configs/clic-ycbcr-q20-80-b4-128.json:
YCbCr 4:2:0, q20-80, blocks 4-128, sparse deflate, 2048x1365 photos) on
the CPU: the streams at its settings against the benchmark's plain
reference on images whose layers tile evenly by no block size (85 and its
chroma 42 are no multiples of 4), in both orientations; the hysteresis's bands at its shapes; and the tracing of the
banded route inside stage A, its kernel launches recorded instead of
made."""

import ctypes
import io
import json

import numpy as np
import pytest
import torch

import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.ops import kernels as K
from aejpeg_tpu_torch.utils import log as L
from benchmark.harness import check, images
from benchmark.harness.registry import Registry

H100_SMEM_OPTIN = 232448      # bytes a block may opt in to on an H100
SHAPES = ((85, 128), (128, 85))
N = 2


def _config():
    config = Registry().config("clic-ycbcr-q20-80-b4-128")
    c = config["codec"]
    return config, at.CodecConfig(c["color_space"], tuple(c["quality_range"]),
                                  tuple(c["block_size_range"]),
                                  c["entropy_level"])


@pytest.fixture(scope="module")
def streamed():
    """Both shapes' seeded images interleaved through one encode_stream
    and one decode_stream on the CPU -> {shape: (u8, blobs, decoded)}."""
    torch.set_num_threads(2)
    _, cfg = _config()
    u8 = {s: images.synth(N, s[0], s[1], 20 + k, "cpu")
          for k, s in enumerate(SHAPES)}
    host = {s: images.to_host_images(u8[s], ".png", at.ImageData)
            for s in SHAPES}
    order = [(s, i) for i in range(N) for s in SHAPES]
    blobs = at.encode_stream([host[s][i] for s, i in order], cfg,
                             batch_size=16, lookahead=2, device="cpu")
    dec = at.decode_stream(blobs, batch_size=16, lookahead=2, device="cpu")
    out = {s: (u8[s], [None] * N, [None] * N) for s in SHAPES}
    for (s, i), b, d in zip(order, blobs, dec):
        out[s][1][i], out[s][2][i] = b, d
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_stream_containers_match_reference(shape, streamed):
    config, _ = _config()
    config["images"].update(height=shape[0], width=shape[1], count=N)
    u8, blobs, _ = streamed[shape]
    tally = check.judge(("container",), config, u8,
                        {k: {"container": b} for k, b in enumerate(blobs)},
                        torch.device("cpu"))
    assert tally.failed == 0
    assert tally.numbers() == {"leaf_mismatch": 0.0, "level_mismatch": 0.0}


@pytest.mark.parametrize("shape", SHAPES)
def test_stream_decodes_match_reference(shape, streamed):
    config, _ = _config()
    config["images"].update(height=shape[0], width=shape[1], count=N)
    u8, blobs, dec = streamed[shape]
    assert all(d.data.shape == shape + (3,) for d in dec)
    tally = check.judge(("image",), config, u8,
                        {k: {"image": d.data, "source": blobs[k]}
                         for k, d in enumerate(dec)}, torch.device("cpu"))
    nums = tally.numbers()
    assert tally.failed == 0
    assert nums["pixel_gap"] < 1e-6 and nums["decode_gap"] < 1e-5


@pytest.mark.parametrize("h, w, rows, bands", [
    (1365, 2048, 342, 4),      # luma: 64 words a row, 453 rows fit
    (682, 1024, 682, 1)])      # chroma: 32 words a row, 907 rows fit
def test_band_rows_at_clic_shapes(h, w, rows, bands):
    got = K.hysteresis_band_rows(h, w, H100_SMEM_OPTIN)
    assert got == rows and -(-h // got) == bands


BUDGET = 8 * 4 * 30        # 29 rows of 128 pixels fit: luma 85x128 in 3
CONVERGED = 2              # the last round that changes a word


def _as(ptr, ctype, n):
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


def _fake_launch(name, device, *args):
    """The hysteresis kernels' effect without the card: the rounds set the
    flag as if round CONVERGED were the last to change a word; the
    resident kernel and the unpack write the plain loop's edge map."""
    if name == "aej_hysteresis_rounds":
        first, n = args[10], args[11]
        ctypes.c_int.from_address(args[4]).value = min(first + n - 1,
                                                       CONVERGED)
        _fake_launch.maps = args[:2]
        return
    if name == "aej_hysteresis":
        maps, (out, p, h, w) = args[:2], args[2:6]
    elif name == "aej_hysteresis_unpack":
        maps, (out, p, h, w) = _fake_launch.maps, args[1:5]
    else:
        raise AssertionError(name)
    strong, weak = (torch.from_numpy(_as(m, ctypes.c_bool, p * h * w)
                                     .reshape(p, h, w)) for m in maps)
    traced, L._logger = L._logger, L._NULL     # the kernel traces nothing
    try:
        edges = K.hysteresis_plain(strong, weak)
    finally:
        L._logger = traced
    _as(out, ctypes.c_float, p * h * w)[:] = edges.reshape(-1).numpy()


def _encode(traced: bool, card_route: bool):
    """encode_batch of two 85x128 images on the CPU -> (blobs, records);
    card_route: the hysteresis takes the card's route with the launches
    faked and a budget under which luma is banded, chroma resident."""
    _, cfg = _config()
    u8 = images.synth(N, 85, 128, 5, "cpu")
    host = images.to_host_images(u8, ".png", at.ImageData)
    sink = io.StringIO()
    before = L._logger
    L._logger = L.StructuredLogger(sink if traced else None)
    try:
        with pytest.MonkeyPatch.context() as mp:
            if card_route:
                route = K._route
                mp.setattr(K, "_route", lambda name, device:
                           name == "hysteresis" or route(name, device))
                mp.setattr(K, "_smem_budget", lambda device: BUDGET)
                mp.setattr(K, "_launch", _fake_launch)
            blobs = at.encode_batch(host, cfg, device="cpu")
    finally:
        L._logger = before
    return blobs, [json.loads(x) for x in sink.getvalue().splitlines()]


def test_banded_route_traced_in_stage_a():
    """Luma (two 85x128 planes) takes the banded route: its
    `stage_a.canny` span holds the plane shape and route as attrs and the
    counts of bands, rounds, checks and launches; chroma (four 42x64
    planes) is resident and counts no bands or rounds.  The containers
    equal the plain route's, traced or not, and nothing is recorded with
    tracing off."""
    plain, _ = _encode(traced=False, card_route=False)
    blobs, recs = _encode(traced=True, card_route=True)
    quiet, none = _encode(traced=False, card_route=True)
    assert blobs == plain and quiet == plain and none == []
    canny = sorted((r for r in recs if r.get("name") == "stage_a.canny"),
                   key=lambda r: r["start_ns"])
    assert [r["attrs"] for r in canny] == [
        {"planes": 2, "h": 85, "w": 128, "route": "banded"},
        {"planes": 4, "h": 42, "w": 64, "route": "resident"}]
    assert canny[0]["counts"] == {
        "hysteresis_checks": 1, "hysteresis_launches": 5,
        "hysteresis_bands": 3, "hysteresis_rounds": CONVERGED + 2}
    assert canny[1]["counts"] == {"hysteresis_checks": 0,
                                  "hysteresis_launches": 1}
    waits = [r for r in recs if r.get("name") == "sync.hysteresis"]
    assert [w["parent"] for w in waits] == [canny[0]["id"]]


def test_plain_route_traced():
    """On the CPU the plain loop runs: the span's route is "plain" and it
    keeps the loop's own counts."""
    _, recs = _encode(traced=True, card_route=False)
    canny = [r for r in recs if r.get("name") == "stage_a.canny"]
    assert len(canny) == 2
    for r in canny:
        assert r["attrs"]["route"] == "plain"
        assert set(r["counts"]) == {"hysteresis_checks",
                                    "hysteresis_steps"}
