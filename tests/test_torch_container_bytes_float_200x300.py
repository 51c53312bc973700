"""The port's encode_batch against the JAX package's, byte for byte, on the
CPU, on float inputs at 200x300 with blocks 4-32, in all seven colour
spaces (a second shape for test_torch_container_bytes_float.py)."""

import pytest

from test_torch_container_bytes import (SPACES, check_batch_matches_jax,
                                        float_arrays)


@pytest.mark.parametrize("space", SPACES)
def test_bytes_float_200x300_blocks_4_32(space):
    check_batch_matches_jax(space, (4, 32), float_arrays(200, 300, 2, 8),
                            u8=False)
