"""The port's batched encode -> .ajpg -> decode against the JAX package's,
on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aejpeg_tpu import CodecConfig as JConfig
from aejpeg_tpu.codec.batch_decode import decode_batch as jdecode
from aejpeg_tpu.codec.batch_encode import _stage_a as j_stage_a
from aejpeg_tpu.codec.batch_encode import encode_batch as jencode
from aejpeg_tpu.io.image import ImageData as JImage
from aejpeg_tpu.metrics.quality import psnr as jpsnr
import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.codec.batch_encode import _host_batch, _stage_a
from aejpeg_tpu_torch.codec.tables import spec_for
from aejpeg_tpu_torch.io.container import ContainerReader
from aejpeg_tpu_torch.metrics import psnr

torch.set_num_threads(1)

CASES = [("YCoCg", (20, 80), (4, 128), (128, 192)),
         ("YCbCr", (50, 50), (8, 8), (128, 192)),
         ("YCoCg", (20, 80), (4, 32), (37, 53)),
         ("ICtCp", (30, 70), (4, 16), (96, 128)),
         ("ICaCb", (20, 80), (4, 32), (64, 96)),
         ("JzAzBz", (20, 80), (4, 32), (64, 96))]
IDS = ["ycocg-q20-80-4-128", "ycbcr-uniform-8", "ycocg-boundary-37x53",
       "ictcp-411-4-16", "icacb-411-4-32", "jzazbz-4-32"]


def _arrays(h, w, n, seed):
    """u8-exact RGB images: gradients, hard-edged blocks, noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        img = np.stack([0.5 + 0.4 * np.sin(x / 9.0 + i) * np.cos(y / 13.0),
                        (x + y) / (h + w),
                        0.5 + 0.3 * np.cos(x / (5.0 + i))], -1)
        img[h // 4:h // 2, w // 3:2 * w // 3] = rng.random(3)
        img += rng.normal(0, 0.03, img.shape)
        out.append((np.round(np.clip(img, 0, 1) * 255) / 255)
                   .astype(np.float32))
    return out


def _port_images(arrays):
    return [at.ImageData.from_array(a, extension=".png") for a in arrays]


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((a - b) ** 2))


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def encoded(request):
    space, q, blocks, (h, w) = request.param
    arrays = _arrays(h, w, 2, seed=h + w)
    jblobs = jencode([JImage.from_array(a, extension=".png") for a in arrays],
                     JConfig(space, q, blocks, entropy_level=-1))
    cfg = at.CodecConfig(space, q, blocks, entropy_level=-1)
    tblobs = at.encode_batch(_port_images(arrays), cfg, device="cpu")
    return dict(arrays=arrays, cfg=cfg, jblobs=jblobs, tblobs=tblobs,
                shape=(h, w))


def test_edge_levels_match_jax(encoded):
    """Stage A's packed has-edge level bits equal (uniform grids run no
    edge stack and pack no bits)."""
    cfg, (h, w) = encoded["cfg"], encoded["shape"]
    mn, mx = cfg.block_size_range
    band = None if mn == mx else (mn.bit_length(), mx.bit_length() - 1)
    batch = _host_batch(_port_images(encoded["arrays"]))
    spec = spec_for(cfg, (h, w))
    ours = _stage_a(torch.from_numpy(batch), cfg.color_space, band,
                    spec)[1].numpy()
    theirs = np.asarray(j_stage_a(jnp.asarray(batch), cfg.color_space,
                                  cfg.layer_shapes((h, w)), band, spec)[1])
    assert (ours.shape[1] == 0) == (band is None)
    np.testing.assert_array_equal(ours, theirs)


def test_containers_match_jax(encoded):
    """Byte-identical containers."""
    assert list(encoded["tblobs"]) == list(encoded["jblobs"])


def test_cross_decode(encoded):
    """Each framework decodes the other's containers to the bits of its own
    decode of the same blob (uint32 views); PSNR within 0.1 dB of JAX's."""
    jb, tb = list(encoded["jblobs"]), list(encoded["tblobs"])
    j_of_t, j_of_j = jdecode(tb), jdecode(jb)
    t_of_t = at.decode_batch(tb, device="cpu")
    t_of_j = at.decode_batch(jb, device="cpu")
    for i, ref in enumerate(encoded["arrays"]):
        assert t_of_t[i].data.shape == ref.shape
        np.testing.assert_array_equal(
            np.ascontiguousarray(j_of_t[i].data, np.float32).view(np.uint32),
            np.ascontiguousarray(t_of_t[i].data, np.float32).view(np.uint32))
        np.testing.assert_array_equal(
            np.ascontiguousarray(t_of_j[i].data, np.float32).view(np.uint32),
            np.ascontiguousarray(j_of_j[i].data, np.float32).view(np.uint32))
        assert abs(_psnr(ref, t_of_t[i].data) - _psnr(ref, j_of_j[i].data)) \
            < 0.1
        assert _psnr(ref, t_of_t[i].data) > 25


def test_batch_vs_single_identity(encoded):
    """A batch's containers are byte-identical to single-image encodes."""
    images = _port_images(encoded["arrays"])
    singles = [at.encode_batch([im], encoded["cfg"], device="cpu")[0]
               for im in images]
    assert singles == list(encoded["tblobs"])


def test_stream_keeps_input_order_with_mixed_shapes():
    cfg = at.CodecConfig("YCoCg", (20, 80), (4, 32), entropy_level=-1)
    a = _arrays(64, 96, 2, seed=1)
    b = _arrays(37, 53, 2, seed=2)
    arrays = [a[0], b[0], a[1], b[1]]
    images = _port_images(arrays)
    blobs = at.encode_stream(images, cfg, batch_size=2, device="cpu")
    for arr, blob in zip(arrays, blobs):
        m = ContainerReader(blob).metadata
        assert (m.height, m.width) == arr.shape[:2]
    assert blobs[0::2] == at.encode_batch(images[0::2], cfg, device="cpu")
    assert blobs[1::2] == at.encode_batch(images[1::2], cfg, device="cpu")
    decoded = at.decode_stream(blobs, batch_size=2, device="cpu")
    for arr, img in zip(arrays, decoded):
        assert img.data.shape == arr.shape
        assert _psnr(arr, img.data) > 25


def test_decode_rejects_mixed_settings():
    cfg = at.CodecConfig("YCoCg", (20, 80), (4, 32), entropy_level=-1)
    blobs = [at.encode_batch(_port_images(_arrays(h, w, 1, seed=3)), cfg,
                             device="cpu")[0]
             for h, w in [(64, 96), (37, 53)]]
    with pytest.raises(ValueError, match="same-shape"):
        at.decode_batch(blobs, device="cpu")


def test_timings_cover_every_stage():
    cfg = at.CodecConfig("YCoCg", (20, 80), (4, 32), entropy_level=-1)
    images = _port_images(_arrays(64, 96, 2, seed=4))
    enc, dec = {}, {}
    blobs = at.encode_batch(images, cfg, timings=enc, device="cpu")
    at.decode_batch(blobs, timings=dec, device="cpu")
    assert set(enc) == {"push", "stage_a", "plans", "device", "pull",
                        "assemble"}
    assert set(dec) == {"parse", "push", "device", "pull"}
    assert all(v >= 0 for v in list(enc.values()) + list(dec.values()))


def test_psnr_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.random((37, 53, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    got = float(psnr(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - float(jpsnr(jnp.asarray(a), jnp.asarray(b)))) < 1e-4
    assert float(psnr(torch.from_numpy(a), torch.from_numpy(a))) == \
        pytest.approx(120.0)
