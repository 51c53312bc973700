"""The port's encode_batch at odd image sizes, on the CPU, byte for byte
against the JAX package's: the chroma planes take the dense resize (an odd
side under 4:2:0; 4:1:1 chroma under 64 wide), on u8-exact and float
inputs.  The 505x632 cases are marked slow.  Two float cases pin the DCT
and quantize in XLA's order (ops/dct.py): at 505x632 and at 200x300
(YCoCg, seed 22) a coefficient lies so near a level boundary that a DCT
summed in another order quantizes it to another level."""

import numpy as np
import pytest

from test_torch_codec import _arrays
from test_torch_container_bytes import check_batch_matches_jax

SPACES = ["YCoCg", "ICtCp"]


def _float_arrays(h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.random((h, w, 3), dtype=np.float32) for _ in range(2)]


@pytest.mark.parametrize("inputs", ["u8", "float"])
@pytest.mark.parametrize("space", SPACES)
def test_bytes_101x149(space, inputs):
    arrays = (_arrays(101, 149, 2, seed=8) if inputs == "u8"
              else _float_arrays(101, 149, 9))
    check_batch_matches_jax(space, (4, 128), arrays, u8=inputs == "u8")


@pytest.mark.slow
def test_bytes_505x632():
    check_batch_matches_jax("YCoCg", (4, 128), _arrays(505, 632, 2, seed=10),
                            u8=True)


def test_bytes_float_200x300_level_boundary():
    check_batch_matches_jax("YCoCg", (4, 128), _float_arrays(200, 300, 22),
                            u8=False)


@pytest.mark.slow
def test_bytes_float_505x632():
    check_batch_matches_jax("YCoCg", (4, 128), _float_arrays(505, 632, 11),
                            u8=False)
