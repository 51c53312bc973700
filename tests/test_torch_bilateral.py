"""The port's bilateral filter bit for bit with jax.jit of the JAX
package's, on the CPU: its colour weights (XLA's exp, a table by |d|), a
hunt over random uint8 planes, and what it feeds, stage A's edge levels
and the containers, on uniform random float images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aejpeg_tpu import CodecConfig as JConfig
from aejpeg_tpu.codec.batch_encode import _stage_a as j_stage_a
from aejpeg_tpu.ops import canny as jc
import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.codec.batch_encode import _host_batch, _stage_a
from aejpeg_tpu_torch.codec.tables import spec_for
from aejpeg_tpu_torch.ops import canny as tc

from test_torch_container_bytes import check_batch_matches_jax

torch.set_num_threads(1)


def test_color_weights_match_xla_exp():
    """The 256 colour weights equal jax.jit's exp(f32(d * d) * cc), which
    torch.exp misses at some of them."""
    cc = np.float32(-0.5 / (75.0 * 75.0))
    d = np.arange(256, dtype=np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.exp(v * v * cc))(d))
    got = tc._color_weights(75.0, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    plain = torch.exp(torch.from_numpy(d * d * cc)).numpy()
    assert (plain.view(np.uint32) != want.view(np.uint32)).any()


def test_bilateral_hunt_random_planes():
    """96 uniform random 200x300 planes against jax.jit(jax.vmap(...)):
    every pixel equal.  Enough planes to show each cause: without the
    fused first product (fma(w0, nb0, w1 * nb1)) 3 pixels differ."""
    ref = jax.jit(jax.vmap(jc.bilateral_u8))
    rng = np.random.default_rng(0)
    for _ in range(12):
        x = rng.integers(0, 256, (8, 200, 300), dtype=np.uint8)
        got = tc.bilateral_u8(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref(x)))


def _uniform_images():
    """Two 200x300 images of uniform random float pixels, whose luma edge
    levels took 2 differing bytes from the bilateral filter."""
    return list(np.random.default_rng(6).random((2, 200, 300, 3),
                                                dtype=np.float32))


@pytest.mark.parametrize("blocks", [(4, 32), (4, 128)], ids=["4-32", "4-128"])
def test_stage_a_levels_uniform_float(blocks):
    """Stage A's planes and packed edge levels equal to jax.jit of the JAX
    stage A."""
    arrays = _uniform_images()
    images = [at.ImageData.from_array(a, extension=".png") for a in arrays]
    batch = _host_batch(images)
    h, w = arrays[0].shape[:2]
    cfg = JConfig("YCoCg", (20, 80), blocks)
    spec = spec_for(at.CodecConfig("YCoCg", (20, 80), blocks), (h, w))
    band = (2, 7)
    ours = _stage_a(torch.from_numpy(batch), "YCoCg", band, spec)
    stage = jax.jit(j_stage_a, static_argnums=(1, 2, 3, 4))
    theirs = stage(jnp.asarray(batch), "YCoCg", cfg.layer_shapes((h, w)),
                   band, spec)
    for a, b in zip(ours[0], theirs[0]):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b).view(np.uint32))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))


def test_bytes_uniform_float_200x300():
    check_batch_matches_jax("YCoCg", (4, 128), _uniform_images(), u8=False)


def test_space_times_colour_is_the_weight_table():
    """The kernel's weight f32(s_w[t] * c_w[|d|]), one float32 product of
    the tap's space weight and the colour weight, equals the (taps, 256)
    table the taps took before, for every tap and every |d|."""
    import math
    sw = [math.exp((dy * dy + dx * dx) * (-0.5 / (75.0 * 75.0)))
          for dy, dx in tc.disk(2)]
    cw = tc._color_weights(75.0, torch.device("cpu"))
    table = torch.tensor(np.asarray(sw, np.float32))[:, None] * cw
    space = np.asarray(tc._bilateral_taps(5, 75.0, 75.0), np.float32)
    assert len(space) == 13 and len(set(space.tolist())) == 4
    each = np.array([[space[t] * np.float32(c) for c in cw.numpy()]
                     for t in range(13)], np.float32)
    np.testing.assert_array_equal(each.view(np.uint32),
                                  table.numpy().view(np.uint32))


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (3, 4), (2, 2),
                                   (5, 7), (37, 53)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_bilateral_unpadded_planes(shape):
    """kernels.bilateral takes the unpadded planes and pads them itself
    (BORDER_REFLECT_101, reflected more than once on planes narrower than
    the disk): bitwise with jax.jit(jax.vmap(bilateral_u8))."""
    x = np.random.default_rng(sum(shape)).integers(0, 256, (3,) + shape,
                                                   dtype=np.uint8)
    want = np.asarray(jax.jit(jax.vmap(jc.bilateral_u8))(x))
    np.testing.assert_array_equal(tc.bilateral_u8(torch.from_numpy(x))
                                  .numpy(), want)


def test_bilateral_wrapper_checks(monkeypatch):
    """kernels.bilateral routed to the card (forced here on CPU tensors, the
    launch recorded instead of made) raises before any launch for inputs
    the kernel does not take, and launches once for the stack's own."""
    from aejpeg_tpu_torch.ops import kernels
    cpu = torch.device("cpu")
    launched = []
    monkeypatch.setattr(kernels, "_route", lambda name, device: True)
    monkeypatch.setattr(kernels, "_launch", lambda *a: launched.append(a))
    space = tc._bilateral_taps(5, 75.0, 75.0)
    colour = tc._color_weights(75.0, cpu)
    planes = torch.zeros((2, 20, 30), dtype=torch.uint8)
    with pytest.raises(TypeError):
        kernels.bilateral(planes.to(torch.int32), colour, space, 2)
    with pytest.raises(ValueError):
        kernels.bilateral(planes, colour[:128].contiguous(), space, 2)
    with pytest.raises(ValueError, match="radius 0-3"):
        kernels.bilateral(planes, colour, (1.0,) * 29, 2)
    with pytest.raises(ValueError, match="radius 0-3"):
        kernels.bilateral(planes, colour, (1.0,) * 49, 4)
    assert not launched
    out = kernels.bilateral(planes, colour, space, 2)
    assert out.shape == (2, 20, 30) and len(launched) == 1
    assert launched[0][0] == "aej_bilateral"
