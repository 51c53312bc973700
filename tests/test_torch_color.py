"""The port's color transforms against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aejpeg_tpu import color as jcolor
from aejpeg_tpu.color import transforms as JT
from aejpeg_tpu_torch import color
from aejpeg_tpu_torch.color import constants as C
from aejpeg_tpu_torch.color import transforms as T

torch.set_num_threads(1)

SPACES = ["sRGB", "YCbCr", "YCoCg", "YCoCg-R", "XYZ", "OKLAB", "ICtCp",
          "ICaCb", "JzAzBz"]
# the PQ spaces' test_matches_jax and test_matches_jax_random cases run in
# a file of their own each (test_torch_color_<space>.py): their 1 M-pixel
# conversions take minutes on one thread
PQ_SPACES = ["ICtCp", "ICaCb", "JzAzBz"]
NON_PQ = [s for s in SPACES if s not in PQ_SPACES]


@pytest.fixture(scope="module")
def lattice():
    v = np.arange(0, 256, 5, dtype=np.float32) / 255.0
    return np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)


def _check_bitwise(space, rgb):
    """Forward on rgb and inverse on JAX's forward image of it: bit for bit
    with jax.jit of the JAX package's conversions."""
    fwd = color.convert("sRGB", space, torch.from_numpy(rgb)).numpy()
    want = np.asarray(jax.jit(lambda x: jcolor.convert("sRGB", space, x))(
        jnp.asarray(rgb)))
    np.testing.assert_array_equal(fwd, want)
    back = color.convert(space, "sRGB", torch.from_numpy(want.copy())).numpy()
    want_back = np.asarray(jax.jit(
        lambda x: jcolor.convert(space, "sRGB", x))(jnp.asarray(want)))
    np.testing.assert_array_equal(back, want_back)


def check_matches_jax(space, lattice):
    """Forward and inverse bitwise equal to JAX (jitted for the CPU) on the
    sRGB lattice and on the forward image of it."""
    _check_bitwise(space, lattice)
    mid, scale = color.normalization_constants(space)
    jmid, jscale = jcolor.normalization_constants(space)
    np.testing.assert_array_equal(mid, jmid)
    np.testing.assert_array_equal(scale, jscale)


def check_matches_jax_random(space):
    """Forward and inverse bitwise equal to JAX on 1 M random float
    pixels in [0, 1)."""
    rgb = np.random.default_rng(11).random((1_000_000, 3), dtype=np.float32)
    _check_bitwise(space, rgb)


@pytest.mark.parametrize("space", NON_PQ)
def test_matches_jax(space, lattice):
    check_matches_jax(space, lattice)


@pytest.mark.parametrize("space", NON_PQ[1:])
def test_matches_jax_random(space):
    check_matches_jax_random(space)


@pytest.mark.parametrize("space", SPACES[1:])
def test_matches_jax_batched(space):
    """Bitwise on a (B, H, W, 3) batch as the codec converts it, whose
    3x3 products XLA rounds otherwise than a 2-D one's, with 5883 pixels
    (rows past the last multiple of 8 take XLA's scalar loop)."""
    rgb = np.random.default_rng(12).random((3, 37, 53, 3), dtype=np.float32)
    _check_bitwise(space, rgb)


@pytest.mark.parametrize("space", SPACES)
def test_lattice_roundtrip(space, lattice):
    """sRGB -> space -> sRGB: max and mean abs error < 1e-4 (the
    reference's bound)."""
    x = torch.from_numpy(lattice)
    back = color.convert(space, "sRGB", color.convert("sRGB", space, x))
    err = (back - x).abs()
    assert float(err.max()) < 1e-4
    assert float(err.mean()) < 1e-4


@pytest.mark.parametrize("space", SPACES[1:])
def test_normalization_roundtrip(space):
    x = torch.rand((4, 5, 3), generator=torch.Generator().manual_seed(0))
    y = color.apply_normalization(space, x, inverse=False)
    assert torch.allclose(color.apply_normalization(space, y, inverse=True),
                          x, atol=1e-6)


def test_public_spaces():
    assert color.get_color_spaces() == jcolor.get_color_spaces()
    assert len(color.get_color_spaces()) == 7


@pytest.mark.parametrize("m2", [C.PQ_M2, C.JZAZBZ_P], ids=["pq", "jzazbz"])
def test_pq_transfer_matches_jax(m2):
    """Both PQ directions bitwise equal to JAX's double-float32 (jitted for
    the CPU), clamps included: y <= 0 -> c1**m2, a luminance in
    (0, 1e-30] -> the value at 1e-30, a subnormal luminance reads as 0,
    and a signal whose numerator is <= 0 -> 0."""
    y = np.concatenate([[-1.0, 0.0, 1e-35, 1e-30, 1e-12, 1e-40, 1e-45],
                        np.geomspace(1e-38, 1e-29, 200),
                        np.geomspace(1e-9, 1.0, 200),
                        np.random.default_rng(5).uniform(0, 1, 20000)]
                       ).astype(np.float32)
    got = T.pq_inverse_eotf(torch.from_numpy(y), m2).numpy()
    want = np.asarray(jax.jit(lambda v: JT.pq_inverse_eotf(v, m2))(y))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[0] == got[1] == np.float32(C.PQ_C1 ** m2)
    e = np.concatenate([[-0.5, 0.0, C.PQ_C1 ** m2 / 10], got[2:],
                        np.linspace(0.0, 1.0, 101)]).astype(np.float32)
    back = T.pq_eotf(torch.from_numpy(e), m2).numpy()
    want = np.asarray(jax.jit(lambda v: JT.pq_eotf(v, m2))(e))
    np.testing.assert_array_equal(back.view(np.uint32), want.view(np.uint32))
    assert back[0] == back[1] == back[2] == 0.0


def _tiny_pixels(low, high, seed, n=4096):
    """(n, 3) float32 pixels, a third of them normal values in [0, 1) and
    the rest log-uniform in [low, high)."""
    rng = np.random.default_rng(seed)
    x = np.exp(rng.uniform(np.log(low), np.log(high), (n, 3)))
    normal = rng.random((n, 3)) < 1 / 3
    x[normal] = rng.random(normal.sum())
    return x.astype(np.float32)


def _check_bits(space, x):
    """Forward on x, and inverse on JAX's forward image of x and on x
    itself: bit for bit (signed zeros included) with jax.jit of the JAX
    package's conversions."""
    for src, dst, inp in (("sRGB", space, x), (space, "sRGB", None)):
        if inp is None:
            inp = np.concatenate([want, x]).astype(np.float32)
        got = color.convert(src, dst, torch.from_numpy(inp)).numpy()
        want = np.asarray(jax.jit(lambda v: jcolor.convert(src, dst, v))(
            jnp.asarray(inp)))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("space", SPACES[1:])
def test_subnormal_pixels_bitwise(space):
    """Subnormal pixels read as zero and every subnormal intermediate is
    flushed, as XLA's CPU code does, in all seven spaces."""
    _check_bits(space, _tiny_pixels(1e-45, 2.0 ** -126, seed=len(space)))


@pytest.mark.parametrize("space", SPACES[1:])
def test_near_subnormal_pixels_bitwise(space):
    """Pixels in [1e-38, 1e-30], whose products and sums fall below
    2**-126, and whose PQ values (ICtCp, ICaCb, JzAzBz) lie at or near the
    1e-30 clamp, where the double-float partial products do."""
    _check_bits(space, _tiny_pixels(1e-38, 1e-30, seed=len(space) + 1))


@pytest.mark.parametrize("space", ["ICtCp", "ICaCb", "JzAzBz"])
def test_pq_spaces_near_the_clamp_batched(space):
    """Pixels whose PQ values lie in [1e-30, 1e-20], as the codec batches
    them (B, H, W, 3): bitwise both ways."""
    x = _tiny_pixels(1e-30, 1e-20, seed=len(space) + 2, n=2 * 16 * 32)
    _check_bits(space, x.reshape(2, 16, 32, 3))


def test_ictcp_inverse_near_black_bitwise():
    """ICtCp values whose PQ signals lie near the 1e-30 clamp (the forward
    image of pixels around 1e-30), where the double-float dots' partial
    products flush: the inverse bitwise equal to JAX's (before the first
    dot folded its zero low part and the second took XLA's per-term
    contractions, 2-3 pixels in 200 differed)."""
    rng = np.random.default_rng(0)
    rgb = (10.0 ** rng.uniform(-31, -29, (60_000, 3))).astype(np.float32)
    rgb[::3] = (10.0 ** rng.uniform(-33, -28, (20_000, 3))).astype(
        np.float32)
    ict = np.asarray(jax.jit(JT.srgb_to_ictcp)(jnp.asarray(rgb)))
    want = np.asarray(jax.jit(lambda v: jcolor.convert("ICtCp", "sRGB", v))(
        jnp.asarray(ict)))
    got = color.convert("ICtCp", "sRGB", torch.from_numpy(ict.copy())).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
