import numpy as np
import torch

import aejpeg_tpu_torch as at
from benchmark.harness import images


def test_same_seed_same_images():
    a = images.synth(2, 40, 56, 12345, "cpu")
    b = images.synth(2, 40, 56, 12345, "cpu")
    c = images.synth(2, 40, 56, 12346, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (2, 40, 56, 3)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_large_seed():
    big = 2 ** 31 + 987654321
    assert torch.equal(images.synth(1, 32, 48, big, "cpu"),
                       images.synth(1, 32, 48, big, "cpu"))


def test_host_images_are_u8_exact():
    u8 = images.synth(2, 32, 48, 7, "cpu")
    host = images.to_host_images(u8, ".png", at.ImageData)
    for k, im in enumerate(host):
        assert im.u8_exact and im.original_shape == (32, 48, 3)
        want = u8[k].numpy().astype(np.float32) / np.float32(255.0)
        assert np.array_equal(im.data, want)


def test_every_seed_gets_the_same_parameters():
    import numpy as np
    a = images._dealt(np.random.default_rng(1), 4, 40, (5, 3))
    b = images._dealt(np.random.default_rng(2), 4, 40, (5, 3))
    assert not np.array_equal(a, b)
    assert np.allclose(np.sort(a.ravel()), np.sort(b.ravel()))
