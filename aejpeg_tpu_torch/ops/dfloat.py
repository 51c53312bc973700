"""Double-float32 ("df32") arithmetic, rounded as the JAX package's
ops/dfloat.py is when XLA compiles it for the CPU.

The JAX package evaluates the PQ transfer function (color/transforms.py)
on (hi, lo) pairs of float32, a workaround for a TPU without float64.  The
port carries the same pairs through the same float32 operations, so that
its colour conversions give the reference's bits.  What XLA does to that
code that changes values is mirrored here, as read off the optimized HLO
and the object code that `XLA_FLAGS=--xla_dump_to=DIR` writes for jax.jit
of the JAX functions (tests/test_torch_color.py checks the result):

- LLVM contracts a float32 product whose only use is an add or a subtract
  into one FMA (`libm.fma32_exact`): a cross product of `df_mul` (which
  one, or none, depends on the code around it), the low part of
  `df_mul_f32`, and the polynomial of XLA's own `log`;
- a division by a constant becomes a product by its float32 reciprocal;
- the code runs with flush-to-zero and denormals-are-zero: a subnormal
  input reads as zero, and every rounded result below 2**-126 is a zero of
  its sign (`_z`).  A pair's low part and the partial products of the
  error-free transforms are about 2**-24 and 2**-48 of the pair, so they
  fall below 2**-126 for pairs under about 2**-78, which the PQ code
  reaches near its 1e-30 clamp.  A product LLVM fuses into an FMA is not
  rounded, so not flushed: `two_prod`'s last partial product always, and
  its third (al*bh, added to the running sum) in most kernels, but not in
  all (`partials_unfused`).

`logf_xla` is the natural logarithm XLA inlines for `jnp.log` on the CPU
(Cephes' polynomial, with the FMAs of its compiled form).  Functions take
and return (hi, lo) tuples of same-shape float32 tensors; a constant pair
is two Python floats equal to float32 values (a float32 tensor meets such
a float in float32 arithmetic on both devices).
"""

import contextlib
import math
import threading
from typing import Tuple

import numpy as np
import torch

from .libm import fma32_exact, ftz

DF = Tuple[torch.Tensor, torch.Tensor]

_SPLIT = 4097.0  # 2**12 + 1 for the 24-bit float32 mantissa


def df_const(x: float) -> Tuple[float, float]:
    """A Python float split into (hi, lo) float32 values."""
    hi = np.float32(x)
    return float(hi), float(np.float32(x - float(hi)))


LN2 = df_const(math.log(2.0))
_RCP_LN2 = float(np.float32(1.0) / np.float32(math.log(2.0)))


# -------------------------------------------------- error-free transforms
_LOCAL = threading.local()


@contextlib.contextmanager
def partials_unfused():
    """Within this block (on this thread) `two_prod` rounds and flushes its
    third partial product on its own, as XLA's kernel for some channels of
    a conversion does (color/transforms.py says which)."""
    prev = getattr(_LOCAL, "unfused", False)
    _LOCAL.unfused = True
    try:
        yield
    finally:
        _LOCAL.unfused = prev


def _z(x):
    """ftz of a tensor result; a Python float (a constant XLA folds on the
    host) passes as it is."""
    return ftz(x) if isinstance(x, torch.Tensor) else x


def two_sum(a, b):
    s = _z(a + b)
    bb = _z(s - a)
    return s, _z(_z(a - _z(s - bb)) + _z(b - bb))


def quick_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    s = _z(a + b)
    return s, _z(b - _z(s - a))


def _split(a):
    """a = hi + lo, each with at most 12 significant bits; a is a float32
    tensor or a Python float equal to a float32 (split in float32)."""
    if not isinstance(a, torch.Tensor):
        t = np.float32(a) * np.float32(_SPLIT)
        hi = t - (t - np.float32(a))
        return float(hi), float(np.float32(a) - hi)
    t = _z(a * _SPLIT)
    hi = _z(t - _z(t - a))
    return hi, _z(a - hi)


def two_prod(a, b, selected: bool = False):
    """Dekker's product from 12-bit splits: every partial product is exact
    (so a contraction changes no value, only which results are flushed).
    LLVM fuses the last partial product into its add, unless the product
    is `selected` (see `df_mul_const`), and the third into its sum where
    `partials_unfused` does not say otherwise."""
    ah, al = _split(a)
    bh, bl = _split(b)
    p3 = al * bh
    if getattr(_LOCAL, "unfused", False):
        p3 = _z(p3)
    p4 = _z(al * bl) if selected else al * bl
    s, e1 = two_sum(_z(ah * bh), _z(ah * bl))
    s, e2 = two_sum(s, p3)
    return quick_two_sum(s, _z(_z(e1 + e2) + p4))



# ------------------------------------------------------------- df algebra
def df(x: torch.Tensor) -> DF:
    return ftz(x), torch.zeros_like(x)


def df_full(c: Tuple[float, float], like: torch.Tensor) -> DF:
    """The constant pair c as tensors shaped like `like`."""
    return torch.full_like(like, c[0]), torch.full_like(like, c[1])


def df_neg(a: DF) -> DF:
    return -a[0], -a[1]


def df_add(a: DF, b: DF) -> DF:
    s, e = two_sum(a[0], b[0])
    return quick_two_sum(s, _z(_z(e + a[1]) + b[1]))


def df_mul(a: DF, b: DF, fuse: str = "a_hi") -> DF:
    """a * b.  LLVM fuses one of the cross products a.hi*b.lo + a.lo*b.hi
    into their sum, which one depends on the code around it: `fuse` names
    a's part in the fused one ("a_hi" or "a_lo"), or is "" where both are
    rounded (see `df_mul_const`)."""
    p, e = two_prod(a[0], b[0], selected=fuse == "")
    if fuse == "a_hi":
        cross = fma32_exact(a[0], b[1], _z(a[1] * b[0]))
    elif fuse == "a_lo":
        cross = fma32_exact(a[1], b[0], _z(a[0] * b[1]))
    else:
        cross = _z(a[0] * b[1]) + _z(a[1] * b[0])
    return quick_two_sum(p, _z(e + _z(cross)))


def df_mul_const(a: DF, x: float, selected: bool = False) -> DF:
    """a times the Python float x as a (hi, lo) pair of constants.  Of the
    cross products a.hi*lo + a.lo*hi LLVM fuses the first, unless lo < 0:
    then the sum becomes a.lo*hi - a.hi*|lo|, and a.lo*hi is fused.
    `selected`: a's parts are `where`s with a constant arm (as `df_exp`
    returns them); LLVM moves a product by a constant into both arms of
    such a select, after which neither product is fused."""
    b = df_const(x)
    return df_mul(a, b, fuse="" if selected else "a_lo" if b[1] < 0 else "a_hi")


def df_mul_const_f32(x: torch.Tensor, c: float) -> DF:
    """df(x) times the Python float c as a (hi, lo) pair of constants,
    where df(x)'s low part is the zero constant: XLA folds that part's
    products and the add of zero, and LLVM fuses the product left,
    x * c.lo, into the sum with two_prod's error."""
    x = ftz(x)
    hi, lo = df_const(c)
    p, e = two_prod(x, hi)
    return quick_two_sum(p, _z(fma32_exact(x, torch.full_like(x, lo), e)))


def df_mul_f32(a: DF, b, selected: bool = False) -> DF:
    """a times a float32 tensor or a Python float equal to a float32;
    `selected` as in `df_mul_const`."""
    p, e = two_prod(a[0], b, selected=selected)
    return quick_two_sum(p, _z(e + _z(a[1] * b)) if selected
                         else _z(fma32_exact(a[1], b, e)))


def df_div(a: DF, b: DF) -> DF:
    q1 = _z(a[0] / b[0])
    r = df_add(a, df_neg(df_mul_f32(b, q1)))
    return quick_two_sum(q1, _z(_z(r[0] + r[1]) / b[0]))


def df_to_f32(a: DF) -> torch.Tensor:
    return ftz(a[0] + a[1])


# -------------------------------------------------------------- df exp/log
_INV_FACT = [1.0 / math.factorial(k) for k in range(3, 13)]


def df_exp(a: DF) -> DF:
    """exp(a) for |a| up to ~80: a = k ln2 + r, the Taylor series of
    exp(r) to r**12/12!, and 2**k from exponent bits."""
    k = torch.round(a[0] * _RCP_LN2)
    r = df_add(a, df_neg(df_mul_f32(df_full(LN2, k), k)))
    p = df_mul(r, r)
    s = df_add(df_add((1.0, 0.0), r), df_mul_f32(p, 0.5))
    for c in _INV_FACT:
        p = df_mul(p, r)
        s = df_add(s, df_mul_const(p, c))
    ki = torch.clamp(k, -126.0, 127.0).to(torch.int32)
    scale = ((ki + 127) << 23).view(torch.float32)
    under, over = k < -126.0, k > 127.0
    hi = torch.where(under, 0.0, ftz(s[0] * scale))
    hi = torch.where(over, torch.inf, hi)
    lo = torch.where(under | over, 0.0, ftz(s[1] * scale))
    return hi, lo


# Cephes' log(1+x) polynomial, as XLA's CPU backend inlines it.
_LOG_P = tuple(float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_SQRT_HALF = float(np.float32(0.707106781186547524))


def logf_xla(x: torch.Tensor) -> torch.Tensor:
    """jnp.log of float32 as XLA compiles it for the CPU: the exponent and
    a mantissa in [sqrt(1/2), sqrt(2)) - 1, an order-8 polynomial in three
    interleaved parts, every product that feeds one add fused."""
    bits = torch.clamp(x, min=2.0 ** -126).view(torch.int32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    low = m < _SQRT_HALF
    xm = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - torch.where(low, 1.0, 0.0)
    x2 = xm * xm
    x3 = x2 * xm
    p = _LOG_P
    y = fma32_exact(fma32_exact(xm, p[0], p[1]), xm, p[2])
    y1 = fma32_exact(fma32_exact(xm, p[3], p[4]), xm, p[5])
    y2 = fma32_exact(fma32_exact(xm, p[6], p[7]), xm, p[8])
    y = fma32_exact(fma32_exact(y, x3, y1), x3, y2)
    y = fma32_exact(y, x3, e * _LOG_Q1)
    out = fma32_exact(e, _LOG_Q2, fma32_exact(x2, -0.5, xm) + y)
    out = torch.where(x == 0, -torch.inf, out)
    out = torch.where(x == torch.inf, torch.inf, out)
    return torch.where((x < 0) | torch.isnan(x), torch.nan, out)


def df_log(a: DF) -> DF:
    """log(a) for a > 0: one Newton step from XLA's float32 log,
    log(a) = l0 + log1p(a exp(-l0) - 1)."""
    l0 = logf_xla(a[0])
    w = df_mul(a, df_exp(df(-l0)), fuse="a_lo")
    rho = df_add(w, (-1.0, 0.0))
    corr = df_add(rho, df(-0.5 * rho[0] * rho[0]))
    return df_add((l0, torch.zeros_like(l0)), corr)


def df_pow(a: DF, p: float) -> DF:
    """a**p for a > 0 and a Python-float exponent p."""
    return df_exp(df_mul_const(df_log(a), p))
