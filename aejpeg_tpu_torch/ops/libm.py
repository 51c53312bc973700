"""glibc's float32 `powf`, bit for bit, from operations that round the same
on the CPU and on CUDA.

The JAX reference's CPU results depend on the host's libm: XLA compiles a
float32 `x ** e` (and `jnp.cbrt`, as `copysign(powf(|x|, f32(1/3)), x)`)
into a call to the C library's `powf`, with the exponent as a float32.
This module pins the algorithm of glibc 2.36 on x86-64 (`__powf_fma`, the
variant its ifunc picks on CPUs with FMA and AVX2), which is Arm's
optimized-routines powf: log2(x) from a 16-entry (1/c, log2 c) table and a
degree-5 polynomial, y*log2(x) in float64, then 2**t from a 32-entry table
and a degree-3 polynomial, rounded once to float32.  The tables and
coefficients below are those of that build's `.rodata`
(`tools/glibc_powf_tables.py` prints them from a libm), and every step the
FMA variant computes with `vfmadd` is an exact float64 FMA here.

Only IEEE-exact operations are used: float64 add, subtract and multiply
(each one eager op, so no compiler contracts them), bit views through
int64 and int32, integer arithmetic and gathers from small tables.  No
`pow`, `exp`, `log` or `exp2` of either backend takes part, so the same ops
give the same bits on both devices.  A host whose libm is not glibc 2.36's
(or an older CPU without FMA) may round a few results of the JAX reference
differently.
"""

import functools

import numpy as np
import torch

_F = float.fromhex

# __powf_log2_data: (1/c, log2(c)) for 16 subintervals of [0x3f330000, 2x),
# then the log2(1+r) polynomial.
_LOG2_INVC = tuple(map(_F, (
    "0x1.661ec79f8f3bep+0", "0x1.571ed4aaf883dp+0", "0x1.49539f0f010b0p+0",
    "0x1.3c995b0b80385p+0", "0x1.30d190c8864a5p+0", "0x1.25e227b0b8ea0p+0",
    "0x1.1bb4a4a1a343fp+0", "0x1.12358f08ae5bap+0", "0x1.0953f419900a7p+0",
    "0x1.0000000000000p+0", "0x1.e608cfd9a47acp-1", "0x1.ca4b31f026aa0p-1",
    "0x1.b2036576afce6p-1", "0x1.9c2d163a1aa2dp-1", "0x1.886e6037841edp-1",
    "0x1.767dcf5534862p-1")))
_LOG2_LOGC = tuple(map(_F, (
    "-0x1.efec65b963019p-2", "-0x1.b0b6832d4fca4p-2", "-0x1.7418b0a1fb77bp-2",
    "-0x1.39de91a6dcf7bp-2", "-0x1.01d9bf3f2b631p-2", "-0x1.97c1d1b3b7af0p-3",
    "-0x1.2f9e393af3c9fp-3", "-0x1.960cbbf788d5cp-4", "-0x1.a6f9db6475fcep-5",
    "0x0.0p+0", "0x1.338ca9f24f53dp-4", "0x1.476a9543891bap-3",
    "0x1.e840b4ac4e4d2p-3", "0x1.40645f0c6651cp-2", "0x1.88e9c2c1b9ff8p-2",
    "0x1.ce0a44eb17bccp-2")))
_LOG2_POLY = tuple(map(_F, (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0")))
_LOG2_OFF = 0x3F330000

# __exp2f_data: bits of 2**(j/32) less j << 47, the rounding shift
# 0x1.8p+52 / 32, and the 2**r polynomial.
_EXP2_TAB = (
    0x3FF0000000000000, 0x3FEFD9B0D3158574, 0x3FEFB5586CF9890F,
    0x3FEF9301D0125B51, 0x3FEF72B83C7D517B, 0x3FEF54873168B9AA,
    0x3FEF387A6E756238, 0x3FEF1E9DF51FDEE1, 0x3FEF06FE0A31B715,
    0x3FEEF1A7373AA9CB, 0x3FEEDEA64C123422, 0x3FEECE086061892D,
    0x3FEEBFDAD5362A27, 0x3FEEB42B569D4F82, 0x3FEEAB07DD485429,
    0x3FEEA47EB03A5585, 0x3FEEA09E667F3BCD, 0x3FEE9F75E8EC5F74,
    0x3FEEA11473EB0187, 0x3FEEA589994CCE13, 0x3FEEACE5422AA0DB,
    0x3FEEB737B0CDC5E5, 0x3FEEC49182A3F090, 0x3FEED503B23E255D,
    0x3FEEE89F995AD3AD, 0x3FEEFF76F2FB5E47, 0x3FEF199BDD85529C,
    0x3FEF3720DCEF9069, 0x3FEF5818DCFBA487, 0x3FEF7C97337B9B5F,
    0x3FEFA4AFA2A490DA, 0x3FEFD0765B6E4540)
_EXP2_SHIFT = _F("0x1.8p+47")
_EXP2_SHIFT_BITS = 0x42E8000000000000
_EXP2_POLY = tuple(map(_F, (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1")))

# The bound of y*log2(x) past which the result overflows.
_OFLOW = _F("0x1.fffffffd1d571p+6")

_SPLITTER = 134217729.0  # 2**27 + 1: Veltkamp's split of a float64
_MASK32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    f64 = dict(dtype=torch.float64, device=device)
    return (torch.tensor(_LOG2_INVC, **f64), torch.tensor(_LOG2_LOGC, **f64),
            torch.tensor(_EXP2_TAB, dtype=torch.int64, device=device))


# ------------------------------------------------------ exact float64 FMA
def _two_sum(a, b):
    """s + err == a + b exactly (Knuth); one of a, b may be a Python
    float."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = a * _SPLITTER
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """p + err == a * b exactly (Dekker), without an FMA; b may be a Python
    float."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_to_odd(v, err):
    """v + err exactly (|err| <= ulp(v)/2) rounded to odd: an inexact v
    with an even last bit moves one ulp toward the exact sum (bits +1 away
    from zero, -1 toward it).  Rounding that to fewer bits, or adding it to
    a larger term, rounds once."""
    bits = v.view(torch.int64)
    nudge = (err != 0) & ((bits & 1) == 0)
    step = torch.where(err * v > 0, 1, -1)
    return torch.where(nudge, (bits + step).view(torch.float64), v)


def fma64(a: torch.Tensor, b, c) -> torch.Tensor:
    """round_f64(a*b + c) with one rounding, a, b, c float64 (b, c may be
    Python floats): the product is split exactly, c is added to its high
    part exactly, and the low parts are summed rounded to odd, after which
    one round-to-nearest addition is correctly rounded (Boldo and
    Melquiond, "Emulation of a FMA and correctly rounded sums: proved
    algorithms using rounding to odd", 2008).  Valid away from overflow and
    underflow."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _round_to_odd(*_two_sum(tl, ul))


def fma32_exact(a: torch.Tensor, b, c) -> torch.Tensor:
    """round_f32(a*b + c) with one rounding, a, b, c float32 (b, c may be
    Python floats equal to float32 values): a*b is exact in float64, and
    the float64 sum rounded to odd rounds once more to float32 correctly.
    (`ops/rounding.fma32`, the CUDA kernels' formula, rounds the float64
    sum to nearest, which errs on the rare sums that are inexact in float64
    and land on a float32 midpoint; the long double-float chains use this
    one.)"""
    f64 = torch.float64
    p = a.to(f64) * (b.to(f64) if isinstance(b, torch.Tensor) else b)
    c = c.to(f64) if isinstance(c, torch.Tensor) else c
    return _round_to_odd(*_two_sum(p, c)).to(torch.float32)


_F32_MIDPOINT_MASK = (1 << 29) - 1
_F32_MIDPOINT = 1 << 28


def fma32_sum(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """round_f32(p + c) with one rounding, where p is float64 holding the
    exact product of two float32 values and c is float32: fma32_exact's
    result at a fraction of its cost.  The float64 sum rounds to float32
    correctly unless it landed exactly on a float32 midpoint after being
    rounded itself; only those sums (about 2**-28 of random ones) are
    recomputed rounded to odd.  Synchronizes with the device once."""
    s = p + c.to(torch.float64)
    mid = (s.view(torch.int64) & _F32_MIDPOINT_MASK) == _F32_MIDPOINT
    if bool(mid.any()):
        c64 = c.to(torch.float64).expand_as(s)[mid]
        s = s.clone()
        s[mid] = _round_to_odd(*_two_sum(p.expand_as(s)[mid], c64))
    return s.to(torch.float32)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """float32 x with subnormals flushed to a zero of their sign: XLA's CPU
    code runs with flush-to-zero and denormals-are-zero.  (x times a 0/1
    mask: a zero keeps x's sign, NaN and inf pass.)"""
    return x * (x.abs() >= 2.0 ** -126)


# -------------------------------------------------------------------- powf
def powf(x: torch.Tensor, e: float) -> torch.Tensor:
    """glibc 2.36's powf(x, e) on a float32 tensor, as XLA's CPU code calls
    it, for a float32 exponent e > 0 that is not an integer (the three in
    use: f32(2.4), f32(1/2.4), f32(1/3)).  As glibc: +-0 -> +0, +-inf ->
    +inf, NaN and finite x < 0 -> NaN, past float32's range -> inf.  XLA
    runs with denormals flushed, so a subnormal x reads as zero where
    glibc normalizes it (x * 2**23), which gives 2**(-150 e), and a result
    below float32's normal range is flushed to zero."""
    assert x.dtype == torch.float32
    assert float(np.float32(e)) == e and 0 < e < np.inf and e != int(e), e
    invc_t, logc_t, exp2_t = _tables(x.device)
    bits = x.view(torch.int32).to(torch.int64) & _MASK32
    ax = bits & 0x7FFFFFFF
    ix = torch.where(ax < 0x00800000, (-(23 << 23)) & _MASK32, ax)

    # log2(x) = log1p(z/c - 1)/ln2 + log2(c) + k, x = 2**k z, z near c.
    tmp = (ix - _LOG2_OFF) & _MASK32
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    iz = (ix - top) & _MASK32
    k = torch.where(top >= 1 << 31, top - (1 << 32), top) // (1 << 23)
    z = iz.to(torch.int32).view(torch.float32).to(torch.float64)
    a0, a1, a2, a3, a4 = _LOG2_POLY
    r = fma64(z, invc_t[i], -1.0)
    y0 = k.to(torch.float64) + logc_t[i]
    r2 = r * r
    y = fma64(r, a0, a1)
    p = fma64(r, a2, a3)
    r4 = r2 * r2
    q = fma64(r, a4, y0)
    q = fma64(r2, p, q)
    ylogx = fma64(y, r4, q) * e

    # 2**t = 2**(kk/32) 2**r, t = kk/32 + r, |r| <= 1/64.
    kd = ylogx + _EXP2_SHIFT
    kk = kd.view(torch.int64) - _EXP2_SHIFT_BITS
    r = ylogx - (kd - _EXP2_SHIFT)
    # The table's bits plus kk << 47: no wrap for |t| < 2**10.
    s = (exp2_t[kk & 31] + kk * (1 << 47)).view(torch.float64)
    c0, c1, c2 = _EXP2_POLY
    out = fma64(fma64(r, c0, c1), r * r, fma64(r, c2, 1.0)) * s
    out = torch.where(out < 2.0 ** -126, 0.0, out).to(torch.float32)
    out = torch.where(ylogx > _OFLOW, torch.inf, out)

    # +-0 and +-inf as x * x, NaN as itself, finite x < 0 invalid.
    neg = (bits >= 1 << 31) & (ax < 0x7F800000) & (ax != 0)
    sp = torch.where(neg, torch.nan, x * x)
    return torch.where((ax == 0) | (ax >= 0x7F800000) | neg, sp, out)
