"""The port's Canny stack, stage by stage, against the JAX package's (each
JAX stage jitted as in its pipeline; the port stage gets the JAX stage's
input)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aejpeg_tpu.ops import canny as jc
from aejpeg_tpu_torch.ops import canny as tc

torch.set_num_threads(1)

# 128x192 takes the CLAHE gather kernel; 96x128 and 37x53 the fallback
SHAPES = [(128, 192), (96, 128), (37, 53)]


def _layers(h, w, seed):
    """Two float planes like stage A's: smooth structure, hard-edged
    blocks, noise, and negative values (chroma) that wrap in to_uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(2):
        img = 0.5 + 0.4 * np.sin(x / (5.0 + 3 * i) + i) * np.cos(y / 9.0)
        img[h // 4:h // 2, w // 3:2 * w // 3] += 0.3
        img += rng.normal(0, 0.05, img.shape)
        out.append(np.clip(img, -0.2, 1.0))
    return np.stack(out).astype(np.float32)


def _jax(fn, planes, *args):
    f = jax.jit(lambda p: fn(p, *args))
    return np.stack([np.asarray(f(jnp.asarray(p))) for p in planes])


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def stages(request):
    """The JAX stack's stage outputs for one shape."""
    h, w = request.param
    layers = _layers(h, w, h + w)
    s = {"layers": layers}
    s["u8"] = _jax(jc.to_uint8, layers)
    s["clahe"] = _jax(jc.clahe, s["u8"])
    s["gauss"] = _jax(jc.gaussian_blur_u8, s["clahe"])
    s["bilateral"] = _jax(jc.bilateral_u8, s["gauss"])
    s["pct"] = np.stack([[float(v) for v in
                          jc.percentiles_u8(jnp.asarray(p), (10.0, 30.0))]
                         for p in s["bilateral"]]).astype(np.float32)
    sob = [jc.sobel_xy(jnp.asarray(p)) for p in s["bilateral"]]
    s["gx"] = np.stack([np.asarray(g[0]) for g in sob])
    s["gy"] = np.stack([np.asarray(g[1]) for g in sob])
    s["edges_nms"] = np.stack([np.asarray(jax.jit(jc._canny_from_gradients)(
        jnp.asarray(s["gx"][i]), jnp.asarray(s["gy"][i]),
        jnp.float32(s["pct"][i, 0]) ** 2, jnp.float32(s["pct"][i, 1]) ** 2))
        for i in range(2)])
    s["edges"] = _jax(jc.canny, layers)
    return s


def test_to_uint8_bitwise(stages):
    got = tc.to_uint8(torch.from_numpy(stages["layers"])).numpy()
    np.testing.assert_array_equal(got, stages["u8"])


def test_clahe_bitwise(stages):
    got = tc.clahe(torch.from_numpy(stages["u8"])).numpy()
    np.testing.assert_array_equal(got, stages["clahe"])


def test_gaussian_bitwise(stages):
    got = tc.gaussian_blur_u8(torch.from_numpy(stages["clahe"])).numpy()
    np.testing.assert_array_equal(got, stages["gauss"])


def test_bilateral_bitwise(stages):
    """XLA's exp (a table by |d|), its FMAs and its first fused product
    (ops/canny.bilateral_u8): every pixel equal."""
    got = tc.bilateral_u8(torch.from_numpy(stages["gauss"])).numpy()
    np.testing.assert_array_equal(got, stages["bilateral"])


def test_percentiles_bitwise(stages):
    lo, hi = tc.percentiles_u8(torch.from_numpy(stages["bilateral"]),
                               (10.0, 30.0))
    got = torch.stack([lo, hi], dim=1).numpy()
    np.testing.assert_array_equal(got, stages["pct"])


def test_sobel_bitwise(stages):
    gx, gy = tc.sobel_xy(torch.from_numpy(stages["bilateral"]))
    np.testing.assert_array_equal(gx.numpy(), stages["gx"])
    np.testing.assert_array_equal(gy.numpy(), stages["gy"])


def test_nms_hysteresis_bitwise(stages):
    pct = torch.from_numpy(stages["pct"])
    got = tc._canny_from_gradients(
        torch.from_numpy(stages["gx"]), torch.from_numpy(stages["gy"]),
        pct[:, 0] * pct[:, 0], pct[:, 1] * pct[:, 1]).numpy()
    np.testing.assert_array_equal(got, stages["edges_nms"])


def test_full_edge_maps(stages):
    """The whole stack from the float planes: every pixel equal."""
    got = tc.canny(torch.from_numpy(stages["layers"])).numpy()
    assert set(np.unique(got)) <= {0.0, 1.0}
    np.testing.assert_array_equal(got, stages["edges"])


def test_hysteresis_long_chain():
    """A weak chain longer than one convergence check (many dilation steps)
    grows fully from one strong end; an isolated weak run does not."""
    weak = torch.zeros((1, 8, 300), dtype=torch.bool)
    weak[0, 2, 5:290] = True
    weak[0, 6, 10:20] = True
    strong = torch.zeros_like(weak)
    strong[0, 2, 289] = True
    out = tc._hysteresis(strong, weak)
    assert out[0, 2, 5:290].all()
    assert not out[0, 6].any()
    assert int(out.sum()) == 285
