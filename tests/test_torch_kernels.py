"""The port's kernel wrappers (plain PyTorch versions on the CPU) against
the JAX package's Pallas kernels (interpret mode on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aejpeg_tpu.ops import canny as jcanny
from aejpeg_tpu.ops import pallas_kernels as jpk
from aejpeg_tpu_torch.ops import canny as tcanny
from aejpeg_tpu_torch.ops import kernels as K

torch.set_num_threads(1)


@pytest.mark.parametrize("t,n,pad", [(16, 6144, 0), (8, 1000, 37),
                                     (3, 129, 5)],
                         ids=["clahe-tiles", "ragged-padded", "tiny"])
def test_histogram256_matches_jax(t, n, pad):
    """Exact counts, bitwise; the -1 padding and N not a multiple of 128
    never count."""
    rng = np.random.default_rng(t * n)
    vals = rng.integers(0, 256, (t, n), dtype=np.int32)
    vals[:, 7] = 0
    vals[:, 8] = 255
    if pad:
        vals[:, n - pad:] = -1
    want = np.asarray(jpk.histogram256(jnp.asarray(vals)))
    got = K.histogram256(torch.from_numpy(vals)[None])[0].numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.sum() == (vals >= 0).sum()


def _words_and_vectors(rng, p, h, w):
    th, tw = -(-h // 4), -(-w // 4)
    luts = rng.integers(0, 256, (p, 4, 4, 256)).astype(np.int32)
    words = (luts[:, :, 0] | (luts[:, :, 1] << 8) | (luts[:, :, 2] << 16)
             | (luts[:, :, 3] << 24))                     # (p, gh, 256)
    vecs = jcanny._clahe_interp_vectors(h, w, th, tw, 4, 4)
    return th, words.astype(np.int32), vecs


@pytest.mark.parametrize("h,w", [(128, 192), (64, 96), (125, 200)])
def test_clahe_apply_gather_matches_jax(h, w):
    """Bitwise: same bytes, OpenCV's association, the reference's FMA
    rounding.  The port takes the uint8 plane, JAX its int32 widening;
    125x200 (tiles 32x50) leaves partial column strips and row bands."""
    rng = np.random.default_rng(h)
    img = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
    th, words, vecs = _words_and_vectors(rng, 2, h, w)
    assert K.clahe_gather_supported(h, w, th, 4, 4)
    got = K.clahe_apply_gather(
        torch.from_numpy(img), torch.from_numpy(words),
        *[torch.from_numpy(v.reshape(-1)) for v in vecs], th=th).numpy()
    for i in range(2):
        want = np.asarray(jpk.clahe_apply_gather(
            jnp.asarray(img[i].astype(np.int32)), jnp.asarray(words[i]),
            *[jnp.asarray(v) for v in vecs], th=th, gh=4))
        np.testing.assert_array_equal(got[i].view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("h,w", [(96, 128), (37, 53)])
def test_clahe_lut_apply_matches_jax(h, w):
    """Within 1 LSB after floor(x + 0.5) at a mismatch rate <= 1e-3 (the
    JAX sum over its 16 tiles is XLA's; the port sums the 4 nonzero taps
    in the same sequential-FMA order, so it measures bit-equal here)."""
    rng = np.random.default_rng(w)
    th, tw = -(-h // 4), -(-w // 4)
    assert not K.clahe_gather_supported(h, w, th, 4, 4)
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    luts = rng.integers(0, 256, (16, 256)).astype(np.float32)
    wts = jcanny._clahe_tile_weights(h, w, th, tw, 4, 4)
    want = np.asarray(jpk.clahe_lut_apply(
        jnp.asarray(img.astype(np.int32)),
        jnp.asarray(luts.T).astype(jnp.bfloat16), jnp.asarray(wts)))
    iy, ix, w4 = tcanny._clahe_taps(h, w, th, tw, 4, 4)
    got = K.clahe_lut_apply(
        torch.from_numpy(img)[None], torch.from_numpy(luts)[None],
        torch.from_numpy(iy), torch.from_numpy(ix), torch.from_numpy(w4),
        gw=4)[0].numpy()
    rounded_diff = np.abs(np.floor(got + 0.5) - np.floor(want + 0.5))
    assert rounded_diff.max() <= 1
    assert (rounded_diff != 0).mean() <= 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_tap_weights_match_jax_table():
    """The 4-tap weights carry exactly the JAX package's (h, w, 16) host
    weights: scattered back, they rebuild the table bit for bit."""
    h, w = 37, 53
    th, tw = -(-h // 4), -(-w // 4)
    iy, ix, w4 = tcanny._clahe_taps(h, w, th, tw, 4, 4)
    taps = (iy[:, None, :, None] * 4 + ix[None, :, None, :]).reshape(h, w, 4)
    full = np.zeros((h, w, 16), np.float32)
    for j in range(4):
        np.add.at(full, (np.arange(h)[:, None], np.arange(w)[None, :],
                         taps[:, :, j]), w4[:, :, j])
    np.testing.assert_array_equal(
        full, jcanny._clahe_tile_weights(h, w, th, tw, 4, 4))


@pytest.mark.parametrize("shape", [(2, 64, 96, 3), (256,), (7, 13)])
def test_u8_to_unit_matches_jax(shape):
    """Bitwise equal to the JAX package's Pallas LUT kernel (interpret mode
    on the CPU), to its closed form and to numpy, every u8 value included."""
    rng = np.random.default_rng(len(shape))
    x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    n = min(256, x.size)
    x.reshape(-1)[:n] = np.arange(n)    # every value where 256 fit
    got = K.u8_to_unit(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    for want in (np.asarray(jpk.u8_to_unit_lut(jnp.asarray(x))),
                 np.asarray(jpk.u8_to_unit_exact(jnp.asarray(x))),
                 x.astype(np.float32) / 255):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_cpu_wrappers_run_plain_versions():
    """CPU tensors take the plain versions: no launch is counted."""
    before = {k: c.n for k, c in K.LAUNCHES.items()}
    K.histogram256(torch.zeros((1, 2, 300), dtype=torch.int32))
    K.u8_to_unit(torch.zeros((3, 5), dtype=torch.uint8))
    rng = np.random.default_rng(0)
    th, words, vecs = _words_and_vectors(rng, 1, 64, 96)
    K.clahe_apply_gather(torch.zeros((1, 64, 96), dtype=torch.uint8),
                         torch.from_numpy(words),
                         *[torch.from_numpy(v.reshape(-1)) for v in vecs],
                         th=th)
    iy, ix, w4 = tcanny._clahe_taps(37, 53, 10, 14, 4, 4)
    K.clahe_lut_apply(torch.zeros((1, 37, 53), dtype=torch.uint8),
                      torch.zeros((1, 16, 256)), torch.from_numpy(iy),
                      torch.from_numpy(ix), torch.from_numpy(w4), gw=4)
    assert {k: c.n for k, c in K.LAUNCHES.items()} == before


@pytest.mark.parametrize("kernel", ["gather", "lut"])
def test_plain_versions_widen_uint8(kernel):
    """Each plain version on a uint8 plane equals, bitwise, the same plane
    widened to int32 first, the pixels the kernels took before."""
    rng = np.random.default_rng(5)
    if kernel == "gather":
        h, w = 64, 96
        th, words, vecs = _words_and_vectors(rng, 2, h, w)
        args = [torch.from_numpy(words)] + [torch.from_numpy(v.reshape(-1))
                                            for v in vecs]

        def run(img):
            return K.clahe_apply_gather_plain(img, *args, th=th)
    else:
        h, w = 37, 53
        iy, ix, w4 = tcanny._clahe_taps(h, w, 10, 14, 4, 4)
        args = [torch.from_numpy(rng.integers(0, 256, (2, 16, 256))
                                 .astype(np.float32))] + [
            torch.from_numpy(a) for a in (iy, ix, w4)]

        def run(img):
            return K.clahe_lut_apply_plain(img, *args, gw=4)
    img = torch.from_numpy(rng.integers(0, 256, (2, h, w), dtype=np.uint8))
    img[0, 0, :2] = torch.tensor([0, 255], dtype=torch.uint8)
    got = run(img)
    want = run(img.to(torch.int32))
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("h,w", [(512, 768), (256, 384), (128, 192),
                                 (125, 200)],
                         ids=["luma", "chroma", "128x192", "125x200"])
def test_inner_blend_fma_is_exact(h, w):
    """The gather kernel computes its inner blends TL*xa1 + TR*xa with the
    hardware FMA, the plain version as round_f32(f64(TL)*f64(xa1) + f64(c))
    with c = f32(TR*xa).  The two are one and the same rounding when the
    float64 sum is exact: TwoSum's error term is 0 for every TL, TR in
    0..255 and every column's (xa, xa1), exhaustively, at the main path's
    widths (luma, chroma) and the tests' gather shapes."""
    th, tw = -(-h // 4), -(-w // 4)
    _, _, xa, xa1, _, _ = tcanny._clahe_interp_vectors(h, w, th, tw, 4, 4)
    pairs = np.unique(np.stack([xa, xa1], 1), axis=0)
    v = np.arange(256, dtype=np.float32)
    tl = np.repeat(v, 256)[None, :]                     # (1, 65536)
    tr = np.tile(v, 256)[None, :]
    for chunk in np.array_split(pairs, max(1, len(pairs) // 16)):
        a32, a132 = chunk[:, :1], chunk[:, 1:]
        prod = tl.astype(np.float64) * a132.astype(np.float64)   # exact
        c = (tr * a32).astype(np.float64)           # f32 product, rounded
        s = prod + c
        bb = s - prod
        err = (prod - (s - bb)) + (c - bb)
        assert not err.any(), "inexact float64 sum: __fmaf_rn != fma32"
    assert len(pairs) >= tw


@pytest.mark.parametrize("case", ["dtype", "rank", "contiguity", "words",
                                  "taps", "u8-dtype", "u8-contiguity",
                                  "pixel-dtype", "taps-pixel-dtype"])
def test_wrappers_validate_inputs(case):
    rng = np.random.default_rng(1)
    th, words, vecs = _words_and_vectors(rng, 1, 64, 96)
    vt = [torch.from_numpy(v.reshape(-1)) for v in vecs]
    img = torch.zeros((1, 64, 96), dtype=torch.uint8)
    iy, ix, w4 = [torch.from_numpy(a)
                  for a in tcanny._clahe_taps(64, 96, 16, 24, 4, 4)]
    with pytest.raises((TypeError, ValueError)):
        if case == "dtype":
            K.histogram256(torch.zeros((1, 2, 8), dtype=torch.int64))
        elif case == "rank":
            K.histogram256(torch.zeros((2, 8), dtype=torch.int32))
        elif case == "contiguity":
            K.histogram256(torch.zeros((1, 8, 2), dtype=torch.int32)
                           .transpose(1, 2))
        elif case == "u8-dtype":
            K.u8_to_unit(torch.zeros((4, 3), dtype=torch.int32))
        elif case == "u8-contiguity":
            K.u8_to_unit(torch.zeros((4, 3), dtype=torch.uint8).t())
        elif case == "words":
            K.clahe_apply_gather(img, torch.from_numpy(words)[:, :, :128],
                                 *vt, th=th)
        elif case == "pixel-dtype":
            K.clahe_apply_gather(img.to(torch.int32), torch.from_numpy(words),
                                 *vt, th=th)
        elif case == "taps-pixel-dtype":
            K.clahe_lut_apply(img.to(torch.int32), torch.zeros((1, 16, 256)),
                              iy, ix, w4, gw=4)
        else:
            K.clahe_lut_apply(img, torch.zeros((1, 16, 256)), iy, ix,
                              torch.zeros((64, 96, 16)), gw=4)
