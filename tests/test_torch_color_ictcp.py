"""The port's ICtCp conversions against the JAX package's, bit for bit:
test_torch_color.py's test_matches_jax and test_matches_jax_random cases
of this space, in a file of their own so that no one file of the colour
tests sets the wall of a parallel run."""

import pytest

from test_torch_color import (check_matches_jax, check_matches_jax_random,
                              lattice)  # noqa: F401  (a fixture)


@pytest.mark.parametrize("space", ["ICtCp"])
def test_matches_jax(space, lattice):
    check_matches_jax(space, lattice)


@pytest.mark.parametrize("space", ["ICtCp"])
def test_matches_jax_random(space):
    check_matches_jax_random(space)
