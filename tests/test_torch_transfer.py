"""The port's transfer functions against XLA's, bit for bit, on the CPU.

XLA compiles a float32 `x ** e` and `jnp.cbrt` into calls to the host's
glibc `powf` (run with denormals flushed); `aejpeg_tpu_torch.ops.libm.powf`
pins that algorithm.  The sweeps stride through the float32 bit patterns
of each exponent's domain; `test_powf_exhaustive` (marked slow) takes every
float32 in [0, 1]."""

import fractions
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aejpeg_tpu.color import transforms as JT
from aejpeg_tpu_torch.color import transforms as T
from aejpeg_tpu_torch.ops import libm

torch.set_num_threads(1)

E_24, E_INV24, E_THIRD = (float(np.float32(e)) for e in (2.4, 1 / 2.4, 1 / 3))


def _floats(lo: float, hi: float, stride: int) -> np.ndarray:
    """Every `stride`-th float32 from lo to hi (both >= 0), and hi."""
    a, b = (np.float32(v).view(np.int32) for v in (lo, hi))
    bits = np.append(np.arange(a, b, stride, dtype=np.int32), b)
    return bits.astype(np.int32).view(np.float32)


def _xla_pow(e: float):
    return jax.jit(lambda v: v ** np.float32(e))


def _assert_bitwise(got, want):
    """Equal bits, NaN for NaN (np.testing treats NaNs as equal)."""
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    zero = np.asarray(want) == 0
    np.testing.assert_array_equal(np.signbit(np.asarray(got))[zero],
                                  np.signbit(np.asarray(want))[zero])


def _cbrt_inputs() -> np.ndarray:
    rng = np.random.default_rng(7)
    sub = np.arange(1, 1 << 23, 4099, dtype=np.int32).view(np.float32)
    return np.concatenate([
        rng.uniform(-0.2, 1.2, 1_000_000).astype(np.float32),
        [0.0, -0.0, np.float32(2.0 ** -149), np.float32(2.0 ** -126)],
        sub, -sub, np.arange(256, dtype=np.float32) / np.float32(255.0),
    ]).astype(np.float32)


@pytest.mark.parametrize("e, x", [
    (E_24, _floats(0.04045, 1.0, 7)),
    (E_INV24, _floats(0.0031308, 1.0, 13)),
], ids=["2.4", "1/2.4"])
def test_powf_matches_xla(e, x):
    """x ** f32(e) over a stride of the domain the sRGB transfer gives it
    (about 5.5 M values each)."""
    _assert_bitwise(libm.powf(torch.from_numpy(x), e).numpy(), _xla_pow(e)(x))


def test_cbrt_matches_xla():
    """jnp.cbrt on 1 M random values in [-0.2, 1.2], zeros, subnormals
    (read as zero under XLA's flush-to-zero, like jnp.cbrt does) and the
    256 u8 levels."""
    x = _cbrt_inputs()
    _assert_bitwise(T._cbrt(torch.from_numpy(x)).numpy(),
                    jax.jit(jnp.cbrt)(x))


def test_powf_special_bases():
    """+-0 -> +0, +-inf -> +inf, NaN and negative bases -> NaN, as
    XLA's x ** e."""
    x = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, -1e-3,
                  -1e-40, 1.0, 3e38], np.float32)
    for e in (E_24, E_INV24, E_THIRD):
        _assert_bitwise(libm.powf(torch.from_numpy(x), e).numpy(),
                        _xla_pow(e)(x))


@pytest.mark.parametrize("fn", ["srgb_to_linear", "linear_to_srgb"])
def test_srgb_transfer_matches_jax(fn):
    """Both sRGB transfer functions over every 97th float32 in [0, 1] and
    the 256 u8 levels, against jax.jit of the JAX package's."""
    x = np.concatenate([_floats(0.0, 1.0, 97),
                        np.arange(256, dtype=np.float32) / np.float32(255.0)])
    _assert_bitwise(getattr(T, fn)(torch.from_numpy(x)).numpy(),
                    jax.jit(getattr(JT, fn))(x))


def _exact(v) -> fractions.Fraction:
    return fractions.Fraction(float(v))


@pytest.mark.parametrize("bits", [64, 32])
def test_fma_is_correctly_rounded(bits):
    """libm.fma64 / fma32_exact equal a*b + c rounded once, on random operands
    and on sums that land next to a rounding midpoint (where a product
    rounded first, or a float64 sum rounded to float32, goes wrong)."""
    rng = np.random.default_rng(bits)
    dt = np.float64 if bits == 64 else np.float32
    n = 4000
    a = rng.uniform(-2, 2, n).astype(dt)
    b = (rng.uniform(-2, 2, n) * 2.0 ** rng.integers(-30, 30, n)).astype(dt)
    # c cancels most of a*b, and c = -round(a*b) + tiny lands near a tie
    c = np.concatenate([rng.uniform(-2, 2, n // 2),
                        -(a * b)[n // 2:] * (1 + rng.uniform(-1e-7, 1e-7,
                                                             n - n // 2))]
                       ).astype(dt)
    fma = libm.fma64 if bits == 64 else libm.fma32_exact
    got = fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    want = [dt(float(_exact(x) * _exact(y) + _exact(z)))
            if bits == 64 else
            dt(np.float64(_round_f32(_exact(x) * _exact(y) + _exact(z))))
            for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, dt))


def _round_f32(q: fractions.Fraction) -> float:
    """q rounded once to the nearest float32 (ties to even)."""
    lo = np.float32(float(q))  # within a float64 ulp of q
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
             np.nextafter(lo, np.float32(np.inf))]
    dist = [abs(_exact(v) - q) for v in cands]
    best = min(dist)
    ties = [v for v, d in zip(cands, dist) if d == best]
    return float(min(ties, key=lambda v: int(np.float32(v).view(np.int32)) & 1))


@pytest.mark.slow
@pytest.mark.parametrize("e", [E_24, E_INV24, E_THIRD],
                         ids=["2.4", "1/2.4", "1/3"])
def test_powf_exhaustive(e):
    """Every float32 in [0, 1], in chunks of 2**23, against XLA's x ** e
    (about 1.07e9 values per exponent)."""
    xla = _xla_pow(e)
    start = time.time()
    stop = int(np.float32(1.0).view(np.int32)) + 1
    torch.set_num_threads(4)
    try:
        for lo in range(0, stop, 1 << 23):
            x = np.arange(lo, min(lo + (1 << 23), stop), dtype=np.int32
                          ).view(np.float32)
            _assert_bitwise(libm.powf(torch.from_numpy(x), e).numpy(),
                            xla(x))
    finally:
        torch.set_num_threads(1)
    print(f"powf e={e}: {stop} values in {time.time() - start:.0f} s")
