"""The port's per-image Codec and uniform-grid device step: against the
port's own batched encoder (identical payloads, identical bytes at the
default entropy level) and against the JAX package's Codec (the tolerances
of tests/test_torch_codec.py), on the CPU."""

import cv2 as cv
import numpy as np
import pytest
import torch

from aejpeg_tpu import CodecConfig as JConfig
from aejpeg_tpu.codec.pipeline import Codec as JCodec
from aejpeg_tpu.io.image import ImageData as JImage
from aejpeg_tpu.parallel.batch import \
    device_encode_uniform as j_device_encode_uniform
import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.io.container import ContainerReader
from aejpeg_tpu_torch.parallel import device_encode_uniform

torch.set_num_threads(1)

CONFIGS = [("YCoCg", (20, 80), (4, 32)), ("YCbCr", (50, 50), (8, 8)),
           ("ICtCp", (30, 70), (4, 16))]
IDS = ["quadtree", "uniform", "ictcp"]


def _arrays(h, w, n, seed):
    rng = np.random.default_rng(seed)
    return [np.clip(cv.resize(rng.random((12, 16, 3), np.float32), (w, h),
                              interpolation=cv.INTER_CUBIC), 0, 1)
            .astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def arrays():
    return _arrays(96, 128, 3, seed=0)


def _images(arrays):
    return [at.ImageData.from_array(a, extension=".png") for a in arrays]


def _assert_same_payloads(a: bytes, b: bytes):
    ra, rb = ContainerReader(a), ContainerReader(b)
    assert ra.metadata == rb.metadata
    for la, lb in zip(ra.read_layers(), rb.read_layers()):
        assert la.bits_len == lb.bits_len
        assert la.root_size == lb.root_size
        assert la.states_bytes == lb.states_bytes
        np.testing.assert_array_equal(la.coeffs, lb.coeffs)


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((a - b) ** 2))


@pytest.mark.parametrize("space,q,blocks", CONFIGS, ids=IDS)
def test_payloads_match_batch(arrays, space, q, blocks):
    """Codec.compress carries encode_batch's payloads (metadata, state
    streams, root sizes, coefficient streams) under the native sparse
    entropy coder."""
    cfg = at.CodecConfig(space, q, blocks, entropy_level=-1)
    images = _images(arrays)
    codec = at.Codec(cfg, device="cpu")
    for blob, img in zip(at.encode_batch(images, cfg, device="cpu"), images):
        _assert_same_payloads(blob, codec.compress(img))


@pytest.mark.parametrize("space,q,blocks", CONFIGS, ids=IDS)
def test_bytes_match_batch_at_default_level(arrays, space, q, blocks):
    cfg = at.CodecConfig(space, q, blocks)
    images = _images(arrays)
    codec = at.Codec(cfg, device="cpu")
    assert at.encode_batch(images, cfg, device="cpu") == \
        [codec.compress(img) for img in images]


@pytest.mark.parametrize("shape", [(100, 120), (94, 50)],
                         ids=["mild-overhang", "deep-reflect"])
def test_boundary_blocks_match_batch(shape):
    """Partial boundary blocks (per-block reflect padding, periodic where a
    block outgrows its region) carry the batch path's coefficients."""
    cfg = at.CodecConfig("YCoCg", (20, 80), (4, 64))
    images = _images(_arrays(*shape, 2, seed=7))
    codec = at.Codec(cfg, device="cpu")
    for blob, img in zip(at.encode_batch(images, cfg, device="cpu"), images):
        assert blob == codec.compress(img)


@pytest.mark.parametrize("space,q,blocks", CONFIGS, ids=IDS)
def test_matches_jax_codec(arrays, space, q, blocks):
    """Against the JAX Codec: equal metadata and root sizes; where the state
    streams agree, coefficients >= 99.99% equal and never more than 1 apart;
    each package decodes the other's containers to within 1e-5 of its own
    decode of the same blob."""
    theirs = JCodec(JConfig(space, q, blocks))
    ours = at.Codec(at.CodecConfig(space, q, blocks), device="cpu")
    n_same = 0
    for arr in arrays:
        jb = theirs.compress(JImage.from_array(arr, extension=".png"))
        tb = ours.compress(at.ImageData.from_array(arr, extension=".png"))
        rj, rt = ContainerReader(jb), ContainerReader(tb)
        assert rj.metadata == rt.metadata
        for lj, lt in zip(rj.read_layers(), rt.read_layers()):
            assert lj.root_size == lt.root_size
            if lj.states_bytes != lt.states_bytes:
                continue
            n_same += 1
            assert (lj.coeffs == lt.coeffs).mean() >= 0.9999
            assert np.abs(lj.coeffs.astype(np.int64) - lt.coeffs).max() <= 1
        t_of_t, t_of_j = ours.decompress(tb).data, ours.decompress(jb).data
        j_of_t, j_of_j = theirs.decompress(tb).data, theirs.decompress(jb).data
        np.testing.assert_allclose(j_of_t, t_of_t, rtol=0, atol=1e-5)
        np.testing.assert_allclose(t_of_j, j_of_j, rtol=0, atol=1e-5)
        assert _psnr(arr, t_of_t) > 25
    assert n_same >= 8      # of 9 layers


@pytest.mark.parametrize("space,q,blocks", CONFIGS[:2], ids=IDS[:2])
def test_decompress_matches_decode_batch(arrays, space, q, blocks):
    cfg = at.CodecConfig(space, q, blocks, entropy_level=-1)
    blobs = at.encode_batch(_images(arrays), cfg, device="cpu")
    codec = at.Codec(device="cpu")
    for arr, blob, dec in zip(arrays, blobs,
                              at.decode_batch(blobs, device="cpu")):
        out = codec.decompress(blob)
        assert out.data.shape == arr.shape and out.extension == ".png"
        np.testing.assert_array_equal(out.data, dec.data)
        assert _psnr(arr, out.data) > 25
    assert codec.config.color_space == space


@pytest.mark.parametrize("space", ["YCbCr", "YCoCg"])
def test_device_encode_uniform_matches_codec(arrays, space):
    """A uniform grid's Morton-ordered coefficient rows are the container's
    coefficient streams."""
    cfg = at.CodecConfig(space, (50, 50), (8, 8))
    for arr in arrays[:2]:
        out = device_encode_uniform(arr, space, block=8, device="cpu")
        blob = at.Codec(cfg, device="cpu").compress(
            at.ImageData.from_array(arr))
        for coeffs, layer in zip(out["coeffs"],
                                 ContainerReader(blob).read_layers()):
            np.testing.assert_array_equal(coeffs.numpy().reshape(-1),
                                          layer.coeffs)
        assert [tuple(e.shape) for e in out["edges"]] == \
            [(96, 128), (48, 64), (48, 64)]


def test_device_encode_uniform_matches_jax(arrays):
    """Coefficients >= 99.99% equal and never more than 1 apart; edge maps
    >= 99.9% equal."""
    ours = device_encode_uniform(arrays[0], "YCoCg", block=8, device="cpu")
    theirs = j_device_encode_uniform(arrays[0], "YCoCg", block=8)
    for a, b in zip(ours["coeffs"], theirs["coeffs"]):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        assert (a == b).mean() >= 0.9999 and np.abs(a - b).max() <= 1
    for a, b in zip(ours["edges"], theirs["edges"]):
        assert (a.numpy() == np.asarray(b)).mean() >= 0.999


def test_update_settings(arrays):
    codec = at.Codec(device="cpu")
    cfg = at.CodecConfig("YCbCr", (50, 50), (8, 8))
    codec.update_settings(cfg)
    assert codec.config == cfg
    blob = codec.compress(at.ImageData.from_array(arrays[0],
                                                  extension=".jpg"))
    assert ContainerReader(blob).metadata.color_space == "YCbCr"
    assert codec.extension == ".jpg"


@pytest.fixture(scope="module")
def arrays_512x768():
    return _arrays(512, 768, 1, seed=9)


@pytest.mark.parametrize("space,q,blocks", CONFIGS, ids=IDS)
def test_bytes_match_jax_codec_at_sparse_level(arrays_512x768, space, q,
                                               blocks):
    """Entropy level -1 at 512x768 (luma's stream spans two 1 MiB chunks):
    the Codec writes the JAX Codec's bytes, through the byte-level sparse
    coder (encode_batch writes the JAX encode_batch's)."""
    arr = arrays_512x768[0]
    theirs = JCodec(JConfig(space, q, blocks, entropy_level=-1)).compress(
        JImage.from_array(arr, extension=".png"))
    ours = at.Codec(at.CodecConfig(space, q, blocks, entropy_level=-1),
                    device="cpu").compress(
        at.ImageData.from_array(arr, extension=".png"))
    assert ours == theirs


def test_failed_compress_leaves_the_codec_reusable(arrays):
    """A compress that raises (a 0-pixel image) leaves nothing behind: the
    same Codec's next compress writes a fresh Codec's bytes."""
    cfg = at.CodecConfig("YCoCg", (20, 80), (4, 32))
    codec = at.Codec(cfg, device="cpu")
    with pytest.raises(ValueError):
        codec.compress(at.ImageData.from_array(
            np.zeros((0, 0, 3), np.float32)))
    img = at.ImageData.from_array(arrays[0], extension=".png")
    assert codec.compress(img) == at.Codec(cfg, device="cpu").compress(img)
    assert codec.extension == ".png"
