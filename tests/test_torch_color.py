"""The port's color transforms against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aejpeg_tpu import color as jcolor
from aejpeg_tpu_torch import color

torch.set_num_threads(1)

SPACES = ["sRGB", "YCbCr", "YCoCg", "YCoCg-R", "XYZ", "OKLAB"]


@pytest.fixture(scope="module")
def lattice():
    v = np.arange(0, 256, 5, dtype=np.float32) / 255.0
    return np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)


@pytest.mark.parametrize("space", SPACES)
def test_matches_jax(space, lattice):
    """Forward and inverse within 2e-6 of JAX (as jitted in its pipeline)
    on the sRGB lattice and on the forward image of it."""
    fwd = color.convert("sRGB", space, torch.from_numpy(lattice)).numpy()
    want = np.asarray(jax.jit(lambda x: jcolor.convert("sRGB", space, x))(
        jnp.asarray(lattice)))
    np.testing.assert_allclose(fwd, want, rtol=0, atol=2e-6)
    back = color.convert(space, "sRGB", torch.from_numpy(want.copy())).numpy()
    want_back = np.asarray(jax.jit(
        lambda x: jcolor.convert(space, "sRGB", x))(jnp.asarray(want)))
    np.testing.assert_allclose(back, want_back, rtol=0, atol=2e-6)
    mid, scale = color.normalization_constants(space)
    jmid, jscale = jcolor.normalization_constants(space)
    np.testing.assert_array_equal(mid, jmid)
    np.testing.assert_array_equal(scale, jscale)


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


@pytest.mark.parametrize("space", ["ICtCp", "ICaCb", "JzAzBz"])
def test_pq_spaces_not_ported(space):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        color.convert("sRGB", space, torch.zeros((2, 3)))
    assert space in color.get_color_spaces()
