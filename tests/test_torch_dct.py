"""The port's DCTs and quantize bit for bit with jax.jit of the JAX
package's, on the CPU: every block size 2-128, dense planes and gathered
blocks, odd plane counts, subnormal, tiny and -0 inputs (uint32 views).
The reference's einsums compile to 2-D dots whose sums XLA orders by the
dot's shape (ops/xla_dot.py); the port sums each pass in that order
(ops/kernels.dct2d, both passes in one launch on the card; its plain
version here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aejpeg_tpu.ops import dct as jdct
from aejpeg_tpu.ops import quant as jquant
from aejpeg_tpu.ops import zigzag as jzigzag
from aejpeg_tpu_torch.ops import dct, kernels, quant

torch.set_num_threads(1)

SIZES = [2, 4, 8, 16, 32, 64, 128]


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _planes(s, seed, count=3):
    side = max(s, 32)
    rng = np.random.default_rng(seed)
    return rng.random((count, 2 * side, 3 * side), dtype=np.float32) \
        - np.float32(0.5)


@pytest.mark.parametrize("s", SIZES)
def test_dense_passes_bitwise(s):
    x = _planes(s, s)
    fwd = dct.dct2_dense(torch.from_numpy(x), s).numpy()
    want = np.asarray(jax.jit(lambda v: jdct.dct2_dense(v, s))(x))
    _assert_bitwise(fwd, want)
    inv = dct.idct2_dense(torch.from_numpy(want.copy())).numpy()
    _assert_bitwise(inv, np.asarray(jax.jit(jdct.idct2_dense)(want)))


@pytest.mark.parametrize("count", [1, 7, 64])
@pytest.mark.parametrize("s", SIZES)
def test_block_forms_bitwise(s, count):
    """dct2 / idct2 of (N, s, s) blocks: the dot has N * s rows, so small
    batches take XLA's own loop or its small-m orders."""
    b = np.random.default_rng(count + s).random((count, s, s),
                                                dtype=np.float32) * 40 - 20
    _assert_bitwise(dct.dct2(torch.from_numpy(b)).numpy(),
                    np.asarray(jax.jit(jdct.dct2)(b)))
    _assert_bitwise(dct.idct2(torch.from_numpy(b)).numpy(),
                    np.asarray(jax.jit(jdct.idct2)(b)))


@pytest.mark.parametrize("s", [8, 32, 128])
def test_tiny_subnormal_and_signed_zero_inputs(s):
    """Inputs near and under 2**-126, -0 and tiny negatives: XLA flushes
    subnormal inputs and results to zeros of their sign."""
    rng = np.random.default_rng(s)
    x = _planes(s, s + 1, count=2)
    x[0] *= np.float32(2.0 ** -120)
    x[0, ::5] = rng.random(x[0, ::5].shape, dtype=np.float32) \
        * np.float32(-(2.0 ** -126))
    x[1, ::3] = np.float32(-0.0)
    x[1, 1::7] = np.float32(2.0 ** -140)
    for fn, jfn in ((lambda v: dct.dct2_dense(v, s),
                     lambda v: jdct.dct2_dense(v, s)),):
        _assert_bitwise(fn(torch.from_numpy(x)).numpy(),
                        np.asarray(jax.jit(jfn)(x)))
    x6 = x.reshape(2, x.shape[1] // s, s, x.shape[2] // s, s)
    _assert_bitwise(dct.idct2_dense(torch.from_numpy(x6)).numpy(),
                    np.asarray(jax.jit(jdct.idct2_dense)(x6)))


def _tables(s, layers, quality=50):
    base = np.random.default_rng(s).integers(2, 60, (8, 8)).astype(
        np.float64)
    tabs = [quant.reciprocal_table(quant.quantization_matrix(
        base, s, quality + 10 * i)) for i in range(layers)]
    return (np.stack([h for h, _ in tabs]), np.stack([lo for _, lo in tabs]))


def test_quantize_bitwise_at_ties():
    """XLA's quantize is fma(y, hi, y*lo): coefficients at and next to the
    half-integer multiples of Q, where one rounding more or less moves the
    level."""
    rng = np.random.default_rng(3)
    q = rng.integers(1, 120, (16, 16)).astype(np.int32)
    hi, lo = jquant.reciprocal_table(q)
    k = rng.integers(-300, 300, (64, 16, 16)).astype(np.float64) + 0.5
    y = (k * q).astype(np.float32)
    y = np.stack([y, np.nextafter(y, np.float32(np.inf)),
                  np.nextafter(y, np.float32(-np.inf)),
                  rng.standard_normal(y.shape).astype(np.float32) * 500])
    want = np.asarray(jax.jit(jquant.quantize)(y, hi, lo))
    got = quant.quantize(torch.from_numpy(y), torch.from_numpy(hi),
                         torch.from_numpy(lo)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("s", SIZES)
def test_dct2_quantize_is_stage_b(s):
    """dct2_quantize (the DCT with quantize, in zigzag block rows) against
    the JAX package's stage-B arithmetic under one jit: dct2_dense, then
    round(y * hi + y * lo) to int16, block transpose and zigzag; two
    layers, plane p of layer p % 2; odd plane count."""
    x = _planes(s, 2 * s, count=3) * np.float32(300)
    hi, lo = _tables(s, 2)
    p, ph, pw = x.shape
    gh, gw = ph // s, pw // s
    layer = np.arange(p) % 2
    zz = jzigzag.zigzag_indices(s)

    def ref(v):
        y = jdct.dct2_dense(v, s)
        h6 = jnp.asarray(hi[layer]).reshape(p, 1, s, 1, s)
        l6 = jnp.asarray(lo[layer]).reshape(p, 1, s, 1, s)
        lv = jnp.round(y * h6 + y * l6).astype(jnp.int16)
        rows = lv.transpose(0, 1, 3, 2, 4).reshape(p, gh * gw, s * s)
        return rows[:, :, jnp.asarray(zz)]

    want = np.asarray(jax.jit(ref)(x))
    got = dct.dct2_quantize(torch.from_numpy(x), s, torch.from_numpy(hi),
                            torch.from_numpy(lo)).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [4, 16, 64])
def test_per_block_and_dense_forms_share_one_band(s):
    """A bucket of the gathered blocks of a (P, ph, pw) stack has the same
    dot rows as the stack, so both forms reach the same periodic-band
    tables and give the same bits: `Codec` and `encode_batch` rely on it."""
    x = _planes(s, 3 * s, count=2)
    p, ph, pw = x.shape
    m = x.size // s
    blocks = x.reshape(p, ph // s, s, pw // s, s).transpose(0, 1, 3, 2, 4) \
        .reshape(-1, s, s)
    assert blocks.shape[0] * s == m
    cpu = torch.device("cpu")
    for inverse in (False, True):
        band = dct.band(s, m, inverse, cpu)
        assert dct.band(s, blocks.shape[0] * s, inverse, cpu) is band
        assert band.period == band.stride == band.src == s
        assert band.dense_lanes() in (1, 2, 4)
    dense = dct.dct2_dense(torch.from_numpy(x), s).permute(0, 1, 3, 2, 4) \
        .reshape(-1, s, s)
    _assert_bitwise(dct.dct2(torch.from_numpy(blocks)).numpy(),
                    dense.numpy())
    y6 = dct.dct2_dense(torch.from_numpy(x), s)
    inv_dense = dct.idct2_dense(y6).permute(0, 1, 3, 2, 4).reshape(-1, s, s)
    _assert_bitwise(dct.idct2(y6.permute(0, 1, 3, 2, 4).reshape(-1, s, s))
                    .numpy(), inv_dense.numpy())


def test_dct_pass_flush_paths_agree():
    """The plain pass skips its flushes when no input can make a result
    under 2**-126; with every flush on, it gives the same bits."""
    s = 16
    x = torch.from_numpy(_planes(s, 5, count=2))
    band = dct.band(s, x.numel() // s, False, torch.device("cpu"))
    fast = kernels.dct_pass_plain(x, band, 1)
    tiny = x.clone()
    tiny[0, 0, 0] = 2.0 ** -100            # forces the flushing path
    slow = kernels.dct_pass_plain(tiny, band, 1)
    _assert_bitwise(fast[1].numpy(), slow[1].numpy())


@pytest.mark.parametrize("s", [3, 6, 12, 48, 96, 256])
def test_card_pass_rejects_other_periods(s):
    """The card's tiles hold whole windows only for a period that is a
    power of two of at most 128: any other raises ValueError there.  On
    the CPU the plain version gives the JAX DCT's bits where XLA's order
    is one dense band (12, 48, 96) and raises ValueError where it is not
    (3, 6)."""
    with pytest.raises(ValueError, match="power of two"):
        kernels.check_card_dense(1, s, 1024)
    if s > 128:
        return
    x = torch.from_numpy(np.random.default_rng(s).random(
        (2, 2 * s, 3 * s), dtype=np.float32))
    if s in (3, 6):
        with pytest.raises(ValueError, match="dense band"):
            dct.dct2_dense(x, s)
        return
    want = np.asarray(jax.jit(jdct.dct2_dense, static_argnums=1)(
        jnp.asarray(x.numpy()), s))
    _assert_bitwise(dct.dct2_dense(x, s).numpy(), want)


def test_dct2d_rejects_what_the_card_cannot_take(monkeypatch):
    """dct2d routed to the card (forced here on CPU tensors, the launch
    recorded instead of made) raises ValueError before any launch for a
    period that is not one of the kernel's block sizes and for planes that
    are not whole blocks; a bench block size launches once."""
    cpu = torch.device("cpu")
    launched = []
    monkeypatch.setattr(kernels, "_route", lambda name, device: True)
    monkeypatch.setattr(kernels, "_launch", lambda *a: launched.append(a))
    count = kernels.LAUNCHES["dct2d"].n
    x = torch.zeros((2, 24, 36))
    with pytest.raises(ValueError, match="power of two"):
        kernels.dct2d(x, dct.band(12, x.numel() // 12, False, cpu))
    x = torch.zeros((2, 16, 20))
    with pytest.raises(ValueError, match="whole blocks"):
        kernels.dct2d(x, dct.band(8, x.numel() // 8, False, cpu))
    assert not launched
    x = torch.zeros((2, 16, 24))
    out = kernels.dct2d(x, dct.band(8, x.numel() // 8, True, cpu))
    assert out.shape == x.shape and len(launched) == 1
    assert launched[0][0] == "aej_dct2d"
    assert kernels.LAUNCHES["dct2d"].n == count + 1


@pytest.mark.parametrize("s", SIZES)
def test_card_pass_takes_every_codec_size(s):
    for lanes in (1, 2, 4):
        kernels.check_card_dense(lanes, s, 2 ** 31 - 1)
    with pytest.raises(ValueError):
        kernels.check_card_dense(3, s, 1024)
    with pytest.raises(ValueError):
        kernels.check_card_dense(1, s, 2 ** 31)


def _non_finite(shape, seed):
    """Random values with NaNs of random payloads and signs (several in a
    block row) and infinities of both signs."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32) - np.float32(0.3)
    bits = (rng.integers(1, 1 << 22, shape) | 0x7F800000
            | (rng.integers(0, 2, shape) << 31)).astype(np.uint32)
    pick = rng.random(shape)
    x = np.where(pick < 0.04, bits.view(np.float32), x)
    x = np.where((pick >= 0.04) & (pick < 0.05), np.float32(np.inf), x)
    return np.where((pick >= 0.05) & (pick < 0.06), np.float32(-np.inf),
                    x).astype(np.float32)


@pytest.mark.parametrize("s", [2, 8, 32, 128])
def test_nan_payloads_bitwise(s):
    """Several NaNs and infinities in one block row: which NaN XLA's dots
    pass on (kernels.nan_model), in every DCT form, payloads included."""
    side = max(s, 16)
    shape = (2, 2 * side, 2 * side) if s < 128 else (1, s, 2 * s)
    x = _non_finite(shape, s)
    _assert_bitwise(dct.dct2_dense(torch.from_numpy(x), s).numpy(),
                    np.asarray(jax.jit(lambda v: jdct.dct2_dense(v, s))(x)))
    x6 = x.reshape(shape[0], shape[1] // s, s, shape[2] // s, s)
    _assert_bitwise(dct.idct2_dense(torch.from_numpy(x6)).numpy(),
                    np.asarray(jax.jit(jdct.idct2_dense)(x6)))
    b = x.reshape(-1, s, s)[:8]
    _assert_bitwise(dct.dct2(torch.from_numpy(b)).numpy(),
                    np.asarray(jax.jit(jdct.dct2)(b)))
    _assert_bitwise(dct.idct2(torch.from_numpy(b)).numpy(),
                    np.asarray(jax.jit(jdct.idct2)(b)))
    add = _non_finite(x.shape, s + 1)
    scale, mid = np.float32(0.8), np.float32(0.5)

    def planes(v, a):
        y = jdct.idct2_dense(v.reshape(x6.shape)).reshape(v.shape)
        return (a + y) / scale + mid
    got = dct.idct2_planes(torch.from_numpy(x), s, add=torch.from_numpy(add),
                           affine=(torch.tensor([np.float32(1) / scale]),
                                   torch.tensor([mid]), 1)).numpy()
    _assert_bitwise(got, np.asarray(jax.jit(planes)(x, add)))
