"""The port's resize2d bit for bit with jax.jit of the JAX package's, on
the CPU, on the dense path (odd and narrow chroma, one dense axis beside a
fast one, upscales), and stage A's planes and levels at sizes that take
it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aejpeg_tpu import CodecConfig as JConfig
from aejpeg_tpu.codec.batch_encode import _stage_a as j_stage_a
from aejpeg_tpu.ops import resize as jresize
import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.codec.batch_encode import _host_batch, _stage_a
from aejpeg_tpu_torch.codec.tables import spec_for
from aejpeg_tpu_torch.ops import resize

from test_torch_codec import _arrays

torch.set_num_threads(1)

AREA = [((37, 53), (19, 27)), ((128, 192), (128, 48)),
        ((101, 256), (51, 128)), ((505, 632), (253, 316)),
        ((482, 627), (241, 314))]
LINEAR = [((19, 27), (37, 53)), ((241, 314), (482, 627)),
          ((256, 384), (512, 768))]
CASES = ([(s, d, "area") for s, d in AREA]
         + [(s, d, "linear") for s, d in LINEAR])
IDS = [f"{k}-{s[0]}x{s[1]}-{d[0]}x{d[1]}" for s, d, k in CASES]


def _jax_resize(img, dst, kind):
    return np.asarray(jax.jit(lambda x: jresize.resize2d(x, dst, kind))(
        jnp.asarray(img)))


def _assert_bitwise(img, dst, kind):
    got = resize.resize2d(torch.from_numpy(img), dst, kind).numpy()
    want = _jax_resize(img, dst, kind)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _planes(src, inputs, seed):
    rng = np.random.default_rng(seed)
    if inputs == "float":
        return rng.random((2,) + src, dtype=np.float32)
    return (rng.integers(0, 256, (2,) + src).astype(np.float32)
            / np.float32(255))


@pytest.mark.parametrize("inputs", ["float", "u8"])
@pytest.mark.parametrize("src,dst,kind", CASES, ids=IDS)
def test_dense_resize_bitwise(src, dst, kind, inputs):
    assert (resize._axis_fast(src[0], dst[0], kind, -2) is None
            or resize._axis_fast(src[1], dst[1], kind, -1) is None)
    _assert_bitwise(_planes(src, inputs, sum(src)), dst, kind)


# thin planes, whose first dot has few rows (the plane's width) and a long
# k: decode's upsample of a 1200x20 image and its kin; and an area resize
# whose dot's last 8 columns sum without FMAs (m = 2)
THIN = [((1, 600, 10), (1200, 20), "linear"), ((1, 800, 5), (1600, 10),
                                               "linear"),
        ((1, 10, 600), (20, 1200), "linear"), ((1, 512, 8), (1024, 16),
                                               "linear"),
        ((2, 1100, 1), (520, 1), "area")]


@pytest.mark.parametrize("inputs", ["float", "u8"])
@pytest.mark.parametrize("shape,dst,kind", THIN, ids=[
    f"{k}-{s[1]}x{s[2]}-{d[0]}x{d[1]}" for s, d, k in THIN])
def test_thin_resize_bitwise(shape, dst, kind, inputs):
    rng = np.random.default_rng(sum(shape))
    if inputs == "float":
        img = rng.random(shape, dtype=np.float32)
    else:
        img = (rng.integers(0, 256, shape).astype(np.float32)
               / np.float32(255))
    _assert_bitwise(img, dst, kind)


@pytest.mark.parametrize("src,dst,kind", CASES[:1] + CASES[5:6],
                         ids=IDS[:1] + IDS[5:6])
@pytest.mark.parametrize("scale", [1.0, 1.0 + 2.0 ** -10, 2.0],
                         ids=["at", "above", "twice"])
def test_dense_resize_at_the_subnormal_bound(src, dst, kind, scale):
    """Pixels at 2**-126 and just above it: the products of pixels by
    weights under 1 fall below 2**-126 and XLA flushes them to zero; a
    subnormal pixel reads as zero."""
    rng = np.random.default_rng(7)
    img = (np.float32(2.0 ** -126 * scale)
           * (1 + rng.random((2,) + src, dtype=np.float32))).astype(
               np.float32)
    img[0, ::3] = rng.random(img[0, ::3].shape, dtype=np.float32) \
        * np.float32(2.0 ** -126)                       # subnormal pixels
    _assert_bitwise(img, dst, kind)


# Both sides of each threshold of ops/resize.xla_dot_plan, through the
# dot whose rows straddle it: (planes, src, dst, kind).
SIDES = [
    # m <= 50 against m > 50 (the second einsum has P * dh rows)
    ((1, 99, 53), (50, 27), "area"), ((1, 101, 53), (51, 27), "area"),
    # n <= 16 against n > 16 at m <= 50
    ((1, 37, 33), (19, 16), "area"), ((1, 37, 35), (19, 17), "area"),
    # XLA's own loop (m, n, k <= 7) against YNNPACK's
    ((1, 7, 7), (4, 4), "area"), ((1, 8, 7), (4, 4), "area"),
    # k = 9 against k = 8 at 8 < n <= 16, m <= 50 (first einsum)
    ((1, 9, 20), (14, 20), "linear"), ((1, 8, 20), (14, 20), "linear"),
    # one k-block against two (k = 512 and 513, tile_k 1)
    ((2, 512, 40), (256, 20), "linear"), ((2, 513, 40), (257, 20), "area"),
    # two k-blocks and a tail past the last multiple of the lanes, which
    # XLA adds after both blocks (k 1033, 2 lanes; k 2049, 4 lanes)
    ((1, 1033, 60), (2066, 60), "linear"), ((1, 2049, 60), (1025, 60), "area"),
]


@pytest.mark.parametrize("shape,dst,kind", SIDES,
                         ids=[f"{s}-{d}-{k}" for s, d, k in SIDES])
def test_dot_plan_thresholds(shape, dst, kind):
    img = np.random.default_rng(sum(shape)).random(shape, dtype=np.float32)
    _assert_bitwise(img, dst, kind)


def test_dot_plan_picks_both_sides():
    """The shapes above do reach both sides of each threshold."""
    plan = resize.xla_dot_plan
    assert plan(50, 53, 27)[0] == 1 and plan(51, 53, 27)[0] == 2
    assert plan(19, 33, 16)[0] == 4 and plan(19, 35, 17)[0] == 1
    assert plan(7, 7, 4) == (1, 7) and plan(7, 8, 4)[0] == 4
    assert plan(20, 9, 14)[0] == 1 and plan(20, 8, 14)[0] == 4
    assert plan(80, 632, 316) == (1, 512)
    assert plan(60, 1033, 2066) == (2, 1024)
    assert plan(60, 2049, 1025) == (4, 2048)
    assert plan(100, 3, 30)[0] == 1 and plan(100, 4, 30)[0] == 2


def test_band_tables_are_cached_per_device():
    a = resize.band("area", 53, 27, 38, torch.device("cpu"))
    assert resize.band("area", 53, 27, 38, torch.device("cpu")) is a


STAGE_A = [("YCoCg", (101, 149)), ("ICtCp", (128, 192)),
           pytest.param("YCoCg", (505, 632), marks=pytest.mark.slow)]


@pytest.mark.parametrize("inputs", ["u8", "float"])
@pytest.mark.parametrize("space,shape", STAGE_A,
                         ids=["YCoCg-101x149", "ICtCp-128x192",
                              "YCoCg-505x632"])
def test_stage_a_matches_jitted_jax(space, shape, inputs):
    """Stage A's normalized planes and packed levels equal to jax.jit of the
    JAX stage A, on u8 and float images whose chroma takes the dense
    resize (4:2:0 of an odd side; 4:1:1 under 64 wide)."""
    h, w = shape
    if inputs == "u8":
        arrays = _arrays(h, w, 2, seed=h)
    else:
        rng = np.random.default_rng(w)
        arrays = [rng.random((h, w, 3), dtype=np.float32) for _ in range(2)]
    images = [at.ImageData.from_array(a, extension=".png") for a in arrays]
    batch = _host_batch(images)
    assert (batch.dtype == np.uint8) == (inputs == "u8")
    cfg = JConfig(space, (20, 80), (4, 128))
    spec = spec_for(at.CodecConfig(space, (20, 80), (4, 128)), (h, w))
    band = (2, 7)
    ours = _stage_a(torch.from_numpy(batch), space, band, spec)
    stage = jax.jit(j_stage_a, static_argnums=(1, 2, 3, 4))
    theirs = stage(jnp.asarray(batch), space, cfg.layer_shapes((h, w)),
                   band, spec)
    for a, b in zip(ours[0], theirs[0]):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))


# XLA's dot runs every k, the band only the non-zero taps: the terms x * 0
# it skips show in the sign of a zero result and in NaN (ops/kernels.py
# banded_resize_plain).
ZERO_SIGN = [CASES[0], CASES[5], (((101, 256), (51, 128), "area"))]
ZERO_IDS = [f"{k}-{s[0]}x{s[1]}" for s, d, k in ZERO_SIGN]


@pytest.mark.parametrize("src,dst,kind", ZERO_SIGN, ids=ZERO_IDS)
@pytest.mark.parametrize("signs", ["negative", "mixed"])
def test_flushed_products_take_xla_zero_signs(src, dst, kind, signs):
    """Pixels whose products with the weights flush to -0: XLA's skipped
    terms x * 0 turn a -0 sum into +0 after a pixel >= +0."""
    rng = np.random.default_rng(sum(src))
    img = -(np.float32(2.0 ** -120)
            * (1 + rng.random((2,) + src, dtype=np.float32))).astype(
                np.float32)
    if signs == "mixed":
        img[:, ::2] *= np.float32(-1)
        img[1, 1::3, ::4] = np.float32(-0.0)
    _assert_bitwise(img, dst, kind)


@pytest.mark.parametrize("src,dst,kind", ZERO_SIGN, ids=ZERO_IDS)
def test_non_finite_pixels_spread_as_in_xla(src, dst, kind):
    """A NaN, +inf and -inf: every output whose dot row holds one is NaN
    (inf * 0), with the bits XLA gives it, or +-inf where the infinity is
    the row's only non-finite tap."""
    img = np.random.default_rng(5).random((2,) + src, dtype=np.float32)
    img[0, 2, 3] = np.nan
    img[1, 5, 7] = np.inf
    img[1, 9, 1] = -np.inf
    _assert_bitwise(img, dst, kind)


# Dots past the domain ops/xla_dot.xla_dot_plan measured first: m <= 50
# with k > 600 (columns in groups of 64, k-blocks by the group's width),
# and k 2-3 with n 3-8 (the first columns of the rows below the last
# multiple of 8 sum as two partial sums), through the band path.
DOTS = [(38, 1100, 33), (20, 800, 100), (38, 1100, 200), (20, 700, 10),
        (100, 2, 5), (100, 3, 8), (51, 2, 7), (1003, 3, 6), (24, 2, 5),
        (20, 2, 5), (17, 3, 4),
        # thin, long dots: XLA's column groups of 64 to n and their
        # k-blocks, and the last columns that sum without FMAs
        (10, 600, 1200), (2, 600, 1200), (20, 600, 1200), (30, 600, 1200),
        (10, 513, 1200), (10, 800, 1200), (5, 800, 1600), (10, 600, 65),
        (10, 600, 100), (6, 960, 200), (2, 1100, 65), (17, 700, 72),
        (42, 300, 1000)]


@pytest.mark.parametrize("m,k,n", DOTS, ids=[f"{m}x{k}x{n}" for m, k, n in
                                               DOTS])
def test_dot_order_past_the_measured_domain(m, k, n):
    from aejpeg_tpu_torch.ops.kernels import banded_resize_plain
    from aejpeg_tpu_torch.ops.xla_dot import make_band
    rng = np.random.default_rng(m + k + n)
    a = rng.random((m, k), dtype=np.float32) - np.float32(0.3)
    b = rng.random((k, n), dtype=np.float32) - np.float32(0.3)
    want = np.asarray(jax.jit(
        lambda x: jnp.dot(x, b, precision="highest"))(a))
    band = make_band(np.ascontiguousarray(b.T), m, torch.device("cpu"))
    got = banded_resize_plain(torch.from_numpy(a.T.copy())[None], band,
                              1)[0].T.numpy()
    np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("m,k,n,unfused", [(2, 1100, 65, 1),
                                            (6, 960, 200, 1),
                                            (10, 600, 1200, 0),
                                            (42, 300, 1000, 0)])
def test_band_flags_its_unfused_outputs(m, k, n, unfused):
    # the kernel builds the no-FMA step only for bands flagged so
    from aejpeg_tpu_torch.ops.xla_dot import make_band
    band = make_band(np.ones((n, k), np.float32), m, torch.device("cpu"))
    assert band.unfused == unfused
    assert band.unfused == int(bool((band.lanes_of == 0).any()))


@pytest.mark.parametrize("src,dst,kind",
                         [((37, 53), (19, 27), "area"),
                          ((19, 27), (37, 53), "linear"),
                          ((600, 10), (1200, 20), "linear"),
                          ((100, 2), (201, 4), "linear")],
                         ids=["area-37x53", "linear-19x27", "thin-600x10",
                              "paired-100x2"])
def test_nan_payloads_bitwise(src, dst, kind):
    """Several NaNs and infinities in one dot row (a NaN or infinity at a
    zero weight too): which NaN XLA's dot passes on (kernels.nan_model),
    payloads included."""
    from test_torch_dct import _non_finite
    _assert_bitwise(_non_finite((2,) + src, sum(src)), dst, kind)
