"""The port's encode_batch against the JAX package's, byte for byte, on the
CPU, on float inputs off the u8 lattice (the float32 upload path) at
128x192 with blocks 4-128, in all seven colour spaces
(test_torch_container_bytes.py says how the cases are split;
test_torch_container_bytes_float_200x300.py holds a second shape).

The colour conversions give the JAX package's bits on every input
(tests/test_torch_color.py), so the non-linear spaces match here as the
linear ones do."""

import pytest

from test_torch_container_bytes import (SPACES, check_batch_matches_jax,
                                        float_arrays)


@pytest.mark.parametrize("space", SPACES)
def test_bytes_float_128x192(space):
    check_batch_matches_jax(space, (4, 128), float_arrays(128, 192, 2, 6),
                            u8=False)
