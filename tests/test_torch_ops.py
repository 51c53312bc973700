"""The port's device ops (DCT, quantize, resize, u8 load, zigzag) against
the JAX package's, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aejpeg_tpu.ops import dct as jdct
from aejpeg_tpu.ops import pallas_kernels as jpk
from aejpeg_tpu.ops import quant as jquant
from aejpeg_tpu.ops import resize as jresize
from aejpeg_tpu.ops import zigzag as jzigzag
from aejpeg_tpu_torch.ops import dct, quant, resize, zigzag
from aejpeg_tpu_torch.ops.rounding import divide

torch.set_num_threads(1)

SIZES = [4, 8, 16, 32, 64, 128]


@pytest.mark.parametrize("s", SIZES)
def test_dct_matches_jax(s):
    """Dense and per-block DCT-II / DCT-III bit for bit (uint32 views) on
    inputs in [-2, 2]: each pass sums in the order of XLA's CPU dot
    (ops/xla_dot.py)."""
    rng = np.random.default_rng(s)
    planes = rng.uniform(-2, 2, (2, 256, 384)).astype(np.float32)
    tp = torch.from_numpy(planes)

    def same(a, b):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                      np.asarray(b).view(np.uint32))

    fwd = dct.dct2_dense(tp, s).numpy()
    same(fwd, jdct.dct2_dense(jnp.asarray(planes), s))
    inv = dct.idct2_dense(torch.from_numpy(fwd)).numpy()
    same(inv, jdct.idct2_dense(jnp.asarray(fwd)))
    np.testing.assert_allclose(inv, planes.reshape(inv.shape), rtol=0,
                               atol=1e-4)
    blocks = planes[0, :2 * s, :s].reshape(2, s, s)
    same(dct.dct2(torch.from_numpy(blocks)).numpy(),
         jdct.dct2(jnp.asarray(blocks)))
    same(dct.idct2(torch.from_numpy(blocks)).numpy(),
         jdct.idct2(jnp.asarray(blocks)))


@pytest.mark.parametrize("quality", [20, 50, 80])
def test_quantize_matches_jax(quality):
    """Quantized levels equal to jax.jit's, which computes
    fma(y, hi, y * lo)."""
    rng = np.random.default_rng(quality)
    qm = quant.quantization_matrix(
        np.full((8, 8), 16, np.float32), 16, quality)
    np.testing.assert_array_equal(
        qm, jquant.quantization_matrix(np.full((8, 8), 16, np.float32), 16,
                                       quality))
    hi, lo = quant.reciprocal_table(qm)
    y = (rng.standard_normal((64, 16, 16)) * 200).astype(np.float32)
    want = np.asarray(jax.jit(jquant.quantize)(
        jnp.asarray(y), jnp.asarray(hi), jnp.asarray(lo)))
    got = quant.quantize(torch.from_numpy(y), torch.from_numpy(hi),
                         torch.from_numpy(lo)).numpy()
    np.testing.assert_array_equal(got, want)
    lv = rng.integers(-50, 50, (8, 16, 16), dtype=np.int16)
    np.testing.assert_array_equal(
        quant.dequantize(torch.from_numpy(lv), torch.from_numpy(qm)).numpy(),
        np.asarray(jquant.dequantize(jnp.asarray(lv), jnp.asarray(qm))))


@pytest.mark.parametrize("src,dst", [((96, 128), (48, 64)),
                                     ((64, 256), (64, 64)),
                                     ((512, 768), (256, 384))],
                         ids=["420-small", "411-width", "420-bench"])
def test_resize_fast_path_bitwise(src, dst):
    """Integer-ratio area downscales take the grouped fast path: bitwise
    equal to JAX (sequential on W, pairwise on H)."""
    h, w = src
    assert resize._axis_fast(w, dst[1], "area", -1) is not None
    rng = np.random.default_rng(h + w)
    img = rng.random((2, 2, h, w)).astype(np.float32)
    got = resize.resize2d(torch.from_numpy(img), dst, "area").numpy()
    want = np.asarray(jax.jit(lambda x: jresize.resize2d(x, dst, "area"))(
        jnp.asarray(img)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("src,dst,kind", [((48, 64), (96, 128), "linear"),
                                          ((37, 53), (74, 106), "linear"),
                                          ((37, 53), (18, 26), "area")])
def test_resize_matmul_path(src, dst, kind):
    """Upsampling and fractional ratios take the dense path: bitwise equal
    to jax.jit of JAX's einsums; the host weight tables are equal."""
    rng = np.random.default_rng(src[0])
    img = rng.random((3,) + src).astype(np.float32)
    got = resize.resize2d(torch.from_numpy(img), dst, kind).numpy()
    want = np.asarray(jax.jit(lambda x: jresize.resize2d(x, dst, kind))(
        jnp.asarray(img)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    fn, jfn = ((resize.linear_weights, jresize.linear_weights)
               if kind == "linear"
               else (resize.area_weights, jresize.area_weights))
    np.testing.assert_array_equal(fn(src[0], dst[0]), jfn(src[0], dst[0]))


def test_u8_load_exhaustive():
    """x.float() / 255 is correctly rounded: equal to numpy, and to the
    JAX package's Pallas LUT oracle (u8_to_unit_lut), for all 256 u8
    values."""
    u8 = np.arange(256, dtype=np.uint8)
    got = divide(torch.from_numpy(u8).to(torch.float32), 255.0).numpy()
    host = u8.astype(np.float32) / 255.0
    np.testing.assert_array_equal(got.view(np.uint32), host.view(np.uint32))
    oracle = np.asarray(jpk.u8_to_unit_lut(jnp.asarray(u8)))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  oracle.view(np.uint32))


@pytest.mark.parametrize("s", SIZES)
def test_zigzag_exact(s):
    np.testing.assert_array_equal(zigzag.zigzag_indices(s),
                                  jzigzag.zigzag_indices(s))
    np.testing.assert_array_equal(zigzag.inverse_zigzag_indices(s),
                                  jzigzag.inverse_zigzag_indices(s))
    rng = np.random.default_rng(s)
    blocks = rng.integers(-99, 99, (3, s, s), dtype=np.int32)
    idx = torch.as_tensor(zigzag.zigzag_indices(s), dtype=torch.long)
    zz = torch.from_numpy(blocks).reshape(3, s * s)[:, idx]
    np.testing.assert_array_equal(
        zz.numpy(), np.asarray(jzigzag.zigzag_gather(jnp.asarray(blocks))))
    inv = torch.as_tensor(zigzag.inverse_zigzag_indices(s), dtype=torch.long)
    np.testing.assert_array_equal(zz[:, inv].reshape(3, s, s).numpy(),
                                  blocks)
