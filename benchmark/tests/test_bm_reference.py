"""The plain reference against the port's CPU path on small images (in
the tests only: the benchmark's runs never compare with the port's own
plain versions), and the container reader's refusals."""

import zlib

import numpy as np
import pytest
import torch

import aejpeg_tpu_torch as at
from benchmark.harness import check, images
from benchmark.harness.registry import Registry
from benchmark.reference import codec as ref
from benchmark.reference import container

CONFIGS = ("live-ycocg-q20-80-b4-128", "kodak-ycocg-q40-80-b4-64-z9")
# The flagship's settings in ICtCp 4:1:1, whose reference conversion is
# not linear (reference/spaces/ICtCp.py).
ICTCP = (CONFIGS[0], "ICtCp")
# The port against the reference in ICtCp at 64x96, n=2.  Measured on the
# CPU over seeds 11-16: leaf_mismatch and level_mismatch 0.0 (the port's
# float32 layers lie within a few ulps of the reference's float64 ones
# rounded, too close to move an edge or a level at this size; on the card
# they can), decode_gap 0.93e-6 to 2.2e-6 (the port decodes in float32:
# near black the PQ curve and sRGB's slope of 12.92 magnify its rounding),
# pixel_gap 1.9e-7 to 2.2e-7.  The TF32 control reads level_mismatch
# 2.6e-3 to 3.5e-3, pixel_gap 2.1e-3 to 3.1e-3, decode_gap 1.5e-2 to 3.9e-2.
ICTCP_BOUNDS = {"leaf_mismatch": 1e-3, "level_mismatch": 3e-4,
                "decode_gap": 1e-5, "pixel_gap": 1e-6}


def _setup(name, h=64, w=96, n=2, seed=11, space=None):
    torch.set_num_threads(2)
    config = Registry().config(name)
    config["images"].update(height=h, width=w, count=n)
    if space:
        config["codec"]["color_space"] = space
    c = config["codec"]
    cfg = at.CodecConfig(c["color_space"], tuple(c["quality_range"]),
                         tuple(c["block_size_range"]), c["entropy_level"])
    u8 = images.synth(n, h, w, seed, "cpu")
    host = images.to_host_images(u8, ".png", at.ImageData)
    return config, cfg, u8, host


def _batch_readings(config, cfg, u8, host):
    """The port's CPU encode_batch and decode_batch judged by check.judge:
    (the containers' numbers, the images' numbers, the containers)."""
    blobs = at.encode_batch(host, cfg, device="cpu")
    enc = check.judge(("container",), config, u8,
                      {k: {"container": b} for k, b in enumerate(blobs)},
                      torch.device("cpu"))
    dec = at.decode_batch(blobs, device="cpu")
    img = check.judge(("image",), config, u8,
                      {k: {"image": d.data, "source": blobs[k]}
                       for k, d in enumerate(dec)}, torch.device("cpu"))
    assert enc.failed == 0 and img.failed == 0
    return enc.numbers(), img.numbers(), blobs


@pytest.mark.parametrize("name, space", [
    *(pytest.param(c, None, id=c) for c in CONFIGS),
    pytest.param(*ICTCP, id="-".join(ICTCP))])
def test_batch_path_matches_reference(name, space):
    enc, img, _ = _batch_readings(*_setup(name, space=space))
    if space is None:
        assert enc == {"leaf_mismatch": 0.0, "level_mismatch": 0.0}
        assert img["pixel_gap"] < 1e-6 and img["decode_gap"] < 1e-5
    else:
        assert check.verdict({**enc, **img}, ICTCP_BOUNDS, 0), (enc, img)


def test_ictcp_control_fails_the_bounds():
    """The reference at TF32 in the port's place, at the same size."""
    config, cfg, u8, host = _setup(ICTCP[0], space=ICTCP[1])
    _, _, blobs = _batch_readings(config, cfg, u8, host)
    cpu = torch.device("cpu")
    enc = check.judge(("container",), config, u8, {0: {}, 1: {}}, cpu,
                      control="tf32").numbers()
    img = check.judge(("image",), config, u8,
                      {k: {"source": b} for k, b in enumerate(blobs)}, cpu,
                      control="tf32").numbers()
    assert not check.verdict({**enc, **img}, ICTCP_BOUNDS, 0), (enc, img)
    assert enc["level_mismatch"] > 3 * ICTCP_BOUNDS["level_mismatch"]


def test_codec_path_matches_reference():
    config, cfg, u8, host = _setup(CONFIGS[1], n=1)
    codec = at.Codec(cfg, device="cpu")
    blob = codec.compress(host[0])
    img = codec.decompress(blob)
    tally = check.judge(("container", "image"), config, u8,
                        {0: {"container": blob, "image": img.data,
                             "source": blob}}, torch.device("cpu"))
    nums = tally.numbers()
    assert tally.failed == 0
    assert nums["leaf_mismatch"] == 0 and nums["level_mismatch"] == 0
    assert nums["pixel_gap"] < 1e-6 and nums["decode_gap"] < 1e-5


def test_decode_gap_sees_a_fault_in_one_block():
    """A fault in one 4x4 block of one image is far under the 99th
    percentile of the pixel gap; the largest gap against the decode of the
    very container decoded sees it."""
    config, cfg, u8, host = _setup(CONFIGS[0])
    blobs = at.encode_batch(host, cfg, device="cpu")
    dec = [d.data.copy() for d in at.decode_batch(blobs, device="cpu")]
    dec[1][8:12, 8:12, 0] += np.float32(0.05)
    tally = check.judge(("image",), config, u8,
                        {k: {"image": d, "source": blobs[k]}
                         for k, d in enumerate(dec)}, torch.device("cpu"))
    nums = tally.numbers()
    assert nums["pixel_gap"] < 1e-6
    assert nums["decode_gap"] > 0.04


def test_reference_decode_inverts_encode_closely():
    config, _, u8, _ = _setup(CONFIGS[0], n=1)
    cfg = check.codec_settings(config)
    layers = ref.encode(u8, cfg)[0]
    rec = ref.decode(layers, cfg, (64, 96), "cpu")
    err = rec - ref.unit(u8[0]).to(torch.float64)
    assert 10 * np.log10(1 / float((err ** 2).mean())) > 25


def _blob():
    config, cfg, _, host = _setup(CONFIGS[1], n=1)
    return config, at.encode_batch(host, cfg, device="cpu")[0]


def test_container_reader_refuses_damage():
    config, blob = _blob()
    meta, layers, orders = container.parse(blob)
    assert meta["height"] == 64 and len(layers) == 3
    assert check.parsed_leaves(blob, config) is not None
    for bad in (blob[:-3], blob + b"\0", b"", blob[:40]):
        assert check.parsed_leaves(bad, config) is None
    other = dict(config, codec=dict(config["codec"], quality_range=[20, 80]))
    assert check.parsed_leaves(blob, other) is None


def test_replay_orders_children():
    # root 4: split, then TL leaf, TR split (four 1-pixel leaves), BL
    # absent, BR leaf
    states = [1, 0, 1, 0, 0, 0, 0, 2, 0]
    bits = np.array([b for s in states for b in ((s >> 1) & 1, s & 1)],
                    np.uint8)
    sizes, ys, xs = container.replay(np.packbits(bits).tobytes(),
                                     len(bits), 4)
    assert sizes.tolist() == [2, 1, 1, 1, 1, 2]
    assert ys.tolist() == [0, 0, 0, 1, 1, 2]
    assert xs.tolist() == [0, 2, 3, 2, 3, 2]
    with pytest.raises(ValueError):
        container.replay(np.packbits(bits[:-2]).tobytes(), len(bits) - 2, 4)


def test_levels_altered_are_seen():
    config, blob = _blob()
    meta, layers, _ = container.parse(blob)
    n = int.from_bytes(blob[:4], "big")
    pos = 4 + n
    bits = int.from_bytes(blob[pos:pos + 4], "big")
    pos += 8 + (bits + 7) // 8
    clen = int.from_bytes(blob[pos:pos + 4], "big")
    raw = np.frombuffer(zlib.decompress(blob[pos + 4:pos + 4 + clen]),
                        "<i4") + 1
    comp = zlib.compress(raw.astype("<i4").tobytes())
    bad = (blob[:pos] + len(comp).to_bytes(4, "big") + comp
           + blob[pos + 4 + clen:])
    got = check.parsed_leaves(bad, config)
    want = check.parsed_leaves(blob, config)
    tally = check.Tally()
    check.compare_leaves(got, want, ref.layer_shapes(
        check.codec_settings(config), (64, 96)), tally)
    assert tally.numbers()["level_mismatch"] > 0.5
