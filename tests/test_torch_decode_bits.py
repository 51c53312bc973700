"""The port's decode_batch bit for bit with the JAX package's (jax.jit of its
stage D) on the CPU, on the same container, at 200x300 in all seven colour
spaces (uint32 views of the decoded pixels).  Stage D sums the sizes'
inverse DCTs, then denormalizes as XLA compiles canvas / scale + mid:
fma(canvas, f32(1 / scale), mid), as the inverse DCT's epilogue
(codec/batch_decode.py)."""

import numpy as np
import pytest
import torch

from aejpeg_tpu import CodecConfig as JConfig
from aejpeg_tpu.codec.batch_decode import decode_batch as jdecode
from aejpeg_tpu.codec.batch_encode import encode_batch as jencode
from aejpeg_tpu.io.image import ImageData as JImage
import aejpeg_tpu_torch as at

from test_torch_codec import _arrays
from test_torch_container_bytes import SPACES

torch.set_num_threads(1)


def _bits(images):
    return [np.ascontiguousarray(im.data, np.float32).view(np.uint32)
            for im in images]


@pytest.mark.parametrize("space", SPACES)
def test_decode_batch_bitwise_200x300(space):
    arrays = _arrays(200, 300, 2, seed=13)
    blobs = jencode([JImage.from_array(a, extension=".png") for a in arrays],
                    JConfig(space, (20, 80), (4, 128), entropy_level=-1))
    ours = at.decode_batch(blobs, device="cpu")
    for a, b in zip(_bits(ours), _bits(jdecode(blobs))):
        np.testing.assert_array_equal(a, b)
