"""The port's batched codec on images whose layers are smaller than the
largest block (a quadtree root below the block band's top), on the CPU:
encode_batch against the port's and the JAX package's per-image Codec, and
every entry point that reaches encode_batch's stage A (the streams, a
mesh, the CLI, the batched metric sweep).

At entropy level 9 the containers are byte-identical.  At level -1 the
batch path's coefficient-domain sparse coder and the Codec's byte-level one
write the same payloads in different deflate streams (on every shape, in
both packages), so there the payloads are held equal and the two Codecs'
bytes."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aejpeg_tpu import CodecConfig as JConfig
from aejpeg_tpu.codec.pipeline import Codec as JCodec
from aejpeg_tpu.io.image import ImageData as JImage
import aejpeg_tpu_torch as at
from aejpeg_tpu_torch import color
from aejpeg_tpu_torch.codec import batch_encode as be
from aejpeg_tpu_torch.codec import quadtree as qt
from aejpeg_tpu_torch.codec.tables import spec_for
from aejpeg_tpu_torch.harness import sweep_batched
from aejpeg_tpu_torch.harness.sweep_batched import BatchedMetricsSweep
from aejpeg_tpu_torch.io.container import ContainerReader
from aejpeg_tpu_torch.ops import kernels, resize
from aejpeg_tpu_torch.ops.canny import canny
from aejpeg_tpu_torch.parallel import make_mesh

from test_torch_codec import _arrays
from test_torch_sweep import rows_by_key, synth

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY = (20, 80)
# (space, blocks, image shape): 96x128 under the bench config's blocks
# (chroma root 64 < 128); 64x64 and 2x2 under the CLI's default 4-64;
# 16x16, 5x7 (a 2x3 chroma layer) under 4-32; 64x64, 33x65 under 2-64;
# ICtCp's 4:1:1 chroma (40x15) with roots equal to the largest block
CASES = [("YCoCg", (4, 128), (96, 128)), ("YCoCg", (4, 64), (64, 64)),
         ("YCoCg", (4, 64), (2, 2)), ("YCoCg", (4, 32), (16, 16)),
         ("YCoCg", (4, 32), (5, 7)), ("YCoCg", (2, 64), (64, 64)),
         ("YCoCg", (2, 64), (33, 65)), ("ICtCp", (4, 64), (40, 60))]
IDS = [f"{s.lower()}-{b[0]}-{b[1]}-{h}x{w}" for s, b, (h, w) in CASES]


def _port(arrays):
    return [at.ImageData.from_array(a, extension=".png") for a in arrays]


def _payloads(blob):
    r = ContainerReader(blob)
    return r.metadata, [(lay.bits_len, lay.root_size, lay.states_bytes,
                         lay.coeffs.tolist()) for lay in r.read_layers()]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    """Both levels' containers of 2 images from encode_batch and from both
    packages' Codec."""
    space, blocks, (h, w) = request.param
    arrays = _arrays(h, w, 2, seed=h * 7 + w)
    out = dict(arrays=arrays, space=space, blocks=blocks)
    for level in (-1, 9):
        cfg = at.CodecConfig(space, QUALITY, blocks, entropy_level=level)
        codec = at.Codec(cfg, device="cpu")
        jcodec = JCodec(JConfig(space, QUALITY, blocks, entropy_level=level))
        out[level] = dict(
            batch=at.encode_batch(_port(arrays), cfg, device="cpu"),
            port=[codec.compress(im) for im in _port(arrays)],
            jax=[jcodec.compress(JImage.from_array(a, extension=".png"))
                 for a in arrays])
    return out


def test_batch_bytes_match_both_codecs(case):
    """Entropy level 9: encode_batch, the port's Codec and the JAX Codec
    write the same bytes."""
    got = case[9]
    assert got["batch"] == got["port"]
    assert got["batch"] == got["jax"]


def test_batch_payloads_match_both_codecs(case):
    """Entropy level -1: encode_batch carries the Codec's payloads; the two
    packages' Codecs write the same bytes."""
    got = case[-1]
    assert got["port"] == got["jax"]
    for blob, ref in zip(got["batch"], got["port"]):
        assert _payloads(blob) == _payloads(ref)


def test_decode_batch_matches_codec_decode(case):
    """The Codec decodes a container bit for bit as decode_batch decodes
    it alone; the batch of two lies within 1e-5 of that (the plain DCT
    follows XLA's dot order, which depends on the dot's rows: at 33x65
    under blocks 2-64 the JAX package's decode_batch of one and of two
    differ in the last bit too)."""
    codec = at.Codec(device="cpu")
    blobs = case[-1]["batch"]
    for arr, blob, dec in zip(case["arrays"], blobs,
                              at.decode_batch(blobs, device="cpu")):
        assert dec.data.shape == arr.shape
        assert np.isfinite(dec.data).all()
        out = codec.decompress(blob).data
        np.testing.assert_array_equal(
            out, at.decode_batch([blob], device="cpu")[0].data)
        np.testing.assert_allclose(dec.data, out, rtol=0, atol=1e-5)


@pytest.mark.parametrize("space,blocks,shape", CASES, ids=IDS)
def test_stage_a_packs_levels_up_to_the_root(space, blocks, shape):
    """Each layer's has-edge levels, max-pooled from its Canny map, for the
    node sizes of the band up to the layer's root and none above it."""
    cfg = at.CodecConfig(space, QUALITY, blocks)
    batch = torch.from_numpy(be._host_batch(_port(_arrays(*shape, 2, 1))))
    band = be.level_band(cfg)
    _, packed = be._stage_a(batch, space, band, spec_for(cfg, shape))
    unit = kernels.u8_to_unit(batch) if batch.dtype == torch.uint8 else batch
    layers = color.convert("sRGB", space, unit)
    want = [[] for _ in range(len(batch))]
    for li, (lh, lw) in enumerate(cfg.layer_shapes(shape)):
        plane = resize.resize2d(layers[..., li][:, None], (lh, lw),
                                       "area")[:, 0]
        root = qt.root_size_for(lh, lw)
        edges = np.zeros((len(batch), root, root), bool)
        edges[:, :lh, :lw] = canny(plane).numpy() == 1.0
        for k in range(band[0], band[1] + 1):
            g = root >> k
            for bi in range(len(batch)):
                want[bi].append(edges[bi, :g << k, :g << k].reshape(
                    g, 1 << k, g, 1 << k).any(axis=(1, 3)).reshape(-1))
    bits = np.concatenate([np.concatenate(row) for row in want]).reshape(
        len(batch), -1)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.packbits(bits, axis=1))


def test_stream_with_a_small_shape():
    """encode_stream over a mixed list whose 16x16 images' roots are below
    the largest block keeps the input order and each group's bytes."""
    cfg = at.CodecConfig("YCoCg", QUALITY, (4, 64), entropy_level=-1)
    a, b = _arrays(96, 128, 2, seed=11), _arrays(16, 16, 2, seed=12)
    images = _port([a[0], b[0], a[1], b[1]])
    blobs = at.encode_stream(images, cfg, batch_size=2, device="cpu")
    assert blobs[0::2] == at.encode_batch(images[0::2], cfg, device="cpu")
    assert blobs[1::2] == at.encode_batch(images[1::2], cfg, device="cpu")
    for im, dec in zip(images, at.decode_stream(blobs, batch_size=2,
                                                device="cpu")):
        assert dec.data.shape == im.data.shape


def test_mesh_on_a_small_shape():
    cfg = at.CodecConfig("YCoCg", QUALITY, (4, 64), entropy_level=-1)
    images = _port(_arrays(64, 64, 2, seed=13))
    mesh = make_mesh((2, 1), devices=["cpu"] * 2)
    want = at.encode_batch(images, cfg, device="cpu")
    assert at.encode_batch(images, cfg, mesh=mesh) == want
    for a, b in zip(at.decode_batch(want, mesh=mesh),
                    at.decode_batch(want, device="cpu")):
        np.testing.assert_array_equal(a.data, b.data)


def test_cli_compress_at_default_settings(tmp_path):
    """`aejpeg-torch compress` of a 64x64 PNG with no codec options (blocks
    4-64 > the 32 chroma root) writes the Codec's bytes."""
    png = str(tmp_path / "icon.png")
    at.ImageData.from_array(_arrays(64, 64, 1, seed=14)[0]).save(png)
    res = subprocess.run(
        [sys.executable, "-m", "aejpeg_tpu_torch.cli", "compress", png,
         "-o", str(tmp_path), "--device", "cpu"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    got = (tmp_path / "icon.ajpg").read_bytes()
    img = at.ImageData.load(png)
    assert got == at.Codec(at.CodecConfig(), device="cpu").compress(img)
    dec = at.Codec(device="cpu").decompress(got)
    assert 10 * np.log10(1 / np.mean((dec.data - img.data) ** 2)) > 25


SWEEP_BLOCKS = [(4, 128), (4, 64), (8, 8)]


def _sweep_files(root):
    """Two 96x128 PNGs (chroma root 64, below the sweep's 128 band top) and
    two 176x208 PNGs."""
    paths = []
    for i, (h, w) in enumerate(((96, 128), (96, 128), (176, 208),
                                (176, 208))):
        p = root / f"img{i}.png"
        at.ImageData.from_array(synth(h, w, 30 + i) / np.float32(255)).save(
            str(p))
        paths.append(p)
    return paths


def _check_against_decode_path(rows, paths, space, metrics):
    imgs = [at.ImageData.load(str(p)) for p in paths]
    for br in SWEEP_BLOCKS:
        cfg = at.CodecConfig(space, QUALITY, br, entropy_level=-1)
        blobs = at.encode_batch(imgs, cfg, device="cpu")
        for p, img, blob, dec in zip(paths, imgs, blobs,
                                     at.decode_batch(blobs, device="cpu")):
            row = rows[(str(p), space, str(QUALITY[0]), str(QUALITY[1]),
                        str(br[0]), str(br[1]))]
            ev = at.EvaluationMetrics(img, dec, device="cpu")
            assert row["compression_ratio"] == \
                f"{img.raw_rgb_bytes / len(blob):.4f}"
            for m in metrics:
                assert row[m] == f"{getattr(ev, m)():.4f}"


def _sweep(paths, out):
    sweep = BatchedMetricsSweep(
        paths, out, color_spaces=("YCoCg",), quality_ranges=[QUALITY],
        block_size_ranges=SWEEP_BLOCKS, entropy_level=-1, device="cpu")
    sweep.run()
    return sweep.errors, rows_by_key(out)


def test_sweep_goes_on_past_a_small_group(tmp_path):
    """The 96x128 group's stage A runs; its combos stop only at MS-SSIM's
    161-pixel bound (both packages' EvaluationMetrics), each on its own,
    and the 176x208 group's rows equal the decode path's."""
    paths = _sweep_files(tmp_path)
    errors, rows = _sweep(paths, tmp_path / "sweep.csv")
    assert len(errors) == len(SWEEP_BLOCKS)
    assert all("(96, 128)" in e and "161" in e for e in errors)
    assert {r["image_name"] for r in rows.values()} == \
        {str(p) for p in paths[2:]}
    _check_against_decode_path(rows, paths[2:], "YCoCg",
                               ("psnr", "ssim", "ms_ssim"))


def test_sweep_rows_of_a_small_group(tmp_path, monkeypatch):
    """With MS-SSIM stubbed out, every row of the 96x128 group is written,
    and its ratio, PSNR and SSIM strings equal the decode path's."""
    monkeypatch.setattr(sweep_batched, "ms_ssim_batch",
                        lambda a, b, r: torch.zeros(a.shape[0],
                                                    device=a.device))
    paths = _sweep_files(tmp_path)[:2]
    errors, rows = _sweep(paths, tmp_path / "sweep.csv")
    assert not errors
    assert len(rows) == len(paths) * len(SWEEP_BLOCKS)
    _check_against_decode_path(rows, paths, "YCoCg", ("psnr", "ssim"))
