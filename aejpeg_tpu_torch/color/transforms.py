"""Color transforms on (..., 3) float32 tensors, bit for bit with the JAX
package's color/transforms.py as jax.jit compiles it for the CPU.

Counterpart of that module (sRGB <-> YCbCr, YCoCg, YCoCg-R, XYZ, OKLAB,
ICtCp, ICaCb, JzAzBz).  Every 3x3 contraction is an explicit sum of three
products, so its rounding does not depend on which matmul kernel a backend
picks.  XLA rewrites the reference as it compiles it, and the port mirrors
each rewrite that changes bits:
- a division by a constant is a product by its float32 reciprocal (`_rcp`);
- a product whose only use is an add is fused into it (`fma32`): `_dot3`
  for a dot of a stacked tensor, `_dot3_columns` where XLA expands the dot
  into multiply-adds, and the multiply-adds it finds elsewhere;
- `x ** e` and `jnp.cbrt` call glibc's powf (ops/libm.py);
- the code runs with flush-to-zero and denormals-are-zero (`ftz`): a
  subnormal input reads as zero, and a product or sum that falls below
  2**-126 is zero.  A float image can hold pixels that small, and a
  product of a tiny pixel by a coefficient under 1 can fall below it, so
  the 3x3 contractions flush each input, product and sum, and so do
  JzAzBz's scalar steps and OKLAB's cube.  A caller whose pixels are 0 or
  at least about 2**-100 in magnitude passes `tiny=False`, which skips
  the flushes of the first contraction only: the codec does for u8 images
  (k/255) and for decoded planes (sums of products of integer levels,
  tables and DCT basis values).  Every later step keeps its flushes,
  since a PQ EOTF or a cube can take such a value below 2**-126.  The
  PQ code's double-float32 pairs flush every rounded result
  (ops/dfloat.py); which of their partial products LLVM fuses (and so
  does not flush) differs between XLA's kernels, per channel
  (`_PQ_UNFUSED`);
- `jnp.clip` gives +0 for -0 (`_clip01`).
The PQ transfer function runs on double-float32 pairs as the JAX
package's does (ops/dfloat.py), with the same clamps at the same places.
"""

import contextlib
import functools
import math

import numpy as np
import torch

from ..ops import dfloat as dfl
from ..ops.libm import ftz, powf
from ..ops.rounding import fma32
from . import constants as C


def _keep(x: torch.Tensor) -> torch.Tensor:
    return x


def _dot3_rows(x: torch.Tensor, m: np.ndarray, fused,
               flush: bool) -> torch.Tensor:
    """out_j = x0*m[j,0] + x1*m[j,1] + x2*m[j,2], left to right; for j in
    `fused` each `+ x_i*m[j,i]` is one FMA (ops/rounding.py), otherwise
    every product and sum rounds.  `flush`: each input, product and sum
    flushed to zero (see the module's docstring)."""
    _flush = ftz if flush else _keep
    x0, x1, x2 = _flush(x[..., 0]), _flush(x[..., 1]), _flush(x[..., 2])

    def prod(xi, c):
        return _flush(xi * float(c))
    return torch.stack(
        [_flush(fma32(x2, m[j, 2], _flush(fma32(x1, m[j, 1],
                                                prod(x0, m[j, 0])))))
         if j in fused else
         _flush(_flush(prod(x0, m[j, 0]) + prod(x1, m[j, 1]))
                + prod(x2, m[j, 2]))
         for j in range(3)], dim=-1)


def _dot3(x: torch.Tensor, m: np.ndarray, flush: bool = True
          ) -> torch.Tensor:
    """(..., 3) @ m.T, rounded as XLA's CPU dot emitter does it.  On a 2-D
    x every product is fused.  A batched x XLA flattens to rows, with m
    transposed, and its loop over 8 rows at a time fuses only out_2's
    products; the rows past the last multiple of 8 take a scalar loop that
    fuses them all."""
    m = np.asarray(m, np.float32)
    if x.dim() == 2:
        return _dot3_rows(x, m, range(3), flush)
    flat = x.reshape(-1, 3)
    body = flat.shape[0] - flat.shape[0] % 8
    out = _dot3_rows(flat[:body], m, (2,), flush)
    if body < flat.shape[0]:
        out = torch.cat([out, _dot3_rows(flat[body:], m, range(3),
                                              flush)])
    return out.reshape(x.shape)


def _dot3_columns(x0, x1, x2, m: np.ndarray) -> torch.Tensor:
    """(x0, x1, x2) @ m.T for three separately computed columns.  On
    columns of a 2-D x XLA expands that product into multiply-adds,
    x0*m[j,0] + x1*m[j,1] + x2*m[j,2], and fuses the first product of each
    add (unlike `_dot3`); on batched columns it emits the stacked dot."""
    if x0.dim() > 1:
        return _dot3(torch.stack([x0, x1, x2], dim=-1), m)
    x0, x1, x2 = ftz(x0), ftz(x1), ftz(x2)
    return torch.stack(
        [ftz(fma32(x2, m[j, 2],
                   ftz(fma32(x0, m[j, 0], ftz(x1 * float(m[j, 1]))))))
         for j in range(3)], dim=-1)


# --------------------------------------------------------------- sRGB <-> lin
def _clip01(x: torch.Tensor) -> torch.Tensor:
    """jnp.clip(x, 0, 1) as XLA computes it: -0 comes out as +0."""
    return torch.clamp(x, 0.0, 1.0) + 0.0


def _f32(c: float) -> float:
    """The float32 nearest c, as a Python float (the constant a float32
    tensor meets in the JAX reference)."""
    return float(np.float32(c))


def _rcp(c: float) -> float:
    """f32(1 / f32(c)): XLA turns a division by a constant into a product
    by the constant's float32 reciprocal."""
    return float(np.float32(1.0) / np.float32(c))


def srgb_to_linear(v: torch.Tensor) -> torch.Tensor:
    """Inverse sRGB transfer function (reference src/color/common.py:34-60),
    as XLA compiles it: both divisions are products by reciprocals, the
    power is glibc's powf, and a subnormal result flushes to zero."""
    base = (torch.clamp(v, min=_f32(0.04045)) + _f32(0.055)) * _rcp(1.055)
    return torch.where(v <= _f32(0.04045), ftz(v * _rcp(12.92)),
                       powf(base, _f32(2.4)))


def linear_to_srgb(v: torch.Tensor) -> torch.Tensor:
    """Forward sRGB transfer + clip to [0,1] (src/color/common.py:62-92):
    1.055 * powf(v, 1/2.4) - 0.055 as one FMA, as XLA compiles it."""
    gamma = fma32(powf(torch.clamp(v, min=_f32(0.0031308)), _f32(1 / 2.4)),
                  _f32(1.055), -_f32(0.055))
    srgb = torch.where(v <= _f32(0.0031308), ftz(v) * _f32(12.92), gamma)
    return _clip01(srgb)


# ------------------------------------------------------------------ 3x3 spaces
# Every conversion takes `tiny`: False when the caller's pixels are 0 or
# at least about 2**-100 in magnitude, which skips the flushes of the
# first contraction on them (see the module's docstring).
def srgb_to_ycbcr(rgb, tiny=True):
    return _dot3(rgb, C.M_SRGB_TO_YCBCR, tiny)


def ycbcr_to_srgb(ycc, tiny=True):
    return _clip01(_dot3(ycc, C.M_YCBCR_TO_SRGB, tiny))


def srgb_to_ycocg(rgb, tiny=True):
    return _dot3(rgb, C.M_SRGB_TO_YCOCG, tiny)


def ycocg_to_srgb(x, tiny=True):
    return _clip01(_dot3(x, C.M_YCOCG_TO_SRGB, tiny))


def srgb_to_ycocg_r(rgb, tiny=True):
    return _dot3(rgb, C.M_SRGB_TO_YCOCG_R, tiny)


def ycocg_r_to_srgb(x, tiny=True):
    return _clip01(_dot3(x, C.M_YCOCG_R_TO_SRGB, tiny))


def srgb_to_xyz(rgb, tiny=True):
    # the linear values of pixels that are not tiny are 0 or above 2**-12
    return _dot3(srgb_to_linear(rgb), C.M_LINEAR_RGB_TO_XYZ, tiny)


def xyz_to_srgb(xyz, tiny=True):
    return linear_to_srgb(_dot3(xyz, C.M_XYZ_TO_LINEAR_RGB, tiny))


# ---------------------------------------------------------------------- OKLAB
def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """jnp.cbrt as XLA compiles it for the CPU:
    copysign(powf(|x|, f32(1/3)), x)."""
    return torch.copysign(powf(x.abs(), _f32(1 / 3)), x)


def srgb_to_oklab(rgb, tiny=True):
    lms = _dot3(srgb_to_xyz(rgb, tiny), C.OKLAB_M_XYZ_TO_LMS)
    return _dot3(_cbrt(lms), C.OKLAB_M_LMSP_TO_LAB)


def oklab_to_srgb(lab, tiny=True):
    lms_p = _dot3(lab, C.OKLAB_M_LAB_TO_LMSP, tiny)
    lms = ftz(ftz(lms_p * lms_p) * lms_p)  # a cube of |x| < 2**-42
    return xyz_to_srgb(_dot3(lms, C.OKLAB_M_LMS_TO_XYZ))


# ------------------------------------------------------------------------ PQ
def _pq_affine(t, c: float, a: float):
    """a + t*c as the JAX package's df_add((a, 0), df_mul_f32(t, c)) is
    compiled: XLA computes the product in three kernels, and LLVM fuses
    t.lo*c into its add in only one of them (the other two take the
    product of the `where` that df_exp returns apart).  The sum's high
    part and error see the unfused product, the rounding step of its low
    part the fused one; at the rare ties between them the result differs
    by an ulp from the source's arithmetic."""
    m = dfl.df_mul_f32(t, c, selected=True)
    s, err = dfl.two_sum(a, m[0])
    e = ftz(err + m[1])
    hi = ftz(s + e)
    return hi, ftz(e - ftz(hi - ftz(a + dfl.df_mul_f32(t, c)[0])))


# The channels whose PQ kernel XLA compiles without fusing the double-float
# product's third partial product (dfloat.partials_unfused), per call site:
# the last channel of each forward transfer (read off jax.jit's results on
# pixels whose PQ values lie near the 1e-30 clamp).
_PQ_UNFUSED = {"ictcp_fwd": (2,), "icacb_fwd": (2,), "jzazbz_fwd": (2,)}


def _per_channel(site: str, fn, x):
    """fn of a (..., 3) tensor or pair, the channels that _PQ_UNFUSED lists
    for `site` computed under partials_unfused and the others as usual
    (each run of neighbouring channels in one call)."""
    unfused = _PQ_UNFUSED.get(site, ())
    if not unfused:
        return fn(x)
    parts, lo = [], 0
    for hi in range(1, 4):
        if hi < 3 and (hi in unfused) == (lo in unfused):
            continue
        xc = (tuple(t[..., lo:hi] for t in x) if isinstance(x, tuple)
              else x[..., lo:hi])
        with (dfl.partials_unfused() if lo in unfused
              else contextlib.nullcontext()):
            parts.append(fn(xc))
        lo = hi
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, dim=-1) for p in zip(*parts))
    return torch.cat(parts, dim=-1)


def _pq_inverse_df(y_df, m2: float):
    """Luminance -> PQ signal, df32 in / df32 out (see pq_inverse_eotf)."""
    yhi, ylo = y_df
    clamp = yhi < _f32(1e-30)
    hi = torch.clamp(yhi, min=_f32(1e-30))
    lo = torch.where(clamp, 0.0, ylo)
    t = dfl.df_pow(dfl.df_mul_const((hi, lo), 1.0 / C.PQ_LP), C.PQ_M1)
    num = _pq_affine(t, _f32(C.PQ_C2), _f32(C.PQ_C1))
    den = _pq_affine(t, _f32(C.PQ_C3), 1.0)
    e = dfl.df_pow(dfl.df_div(num, den), m2)
    z_hi, z_lo = dfl.df_const(float(C.PQ_C1) ** m2)
    mask = yhi <= 0.0
    return torch.where(mask, z_hi, e[0]), torch.where(mask, z_lo, e[1])


def pq_inverse_eotf(y: torch.Tensor, m2: float = C.PQ_M2) -> torch.Tensor:
    """Luminance -> PQ signal (src/color/common.py:131-159): y <= 0 maps to
    c1**m2, the base is floored at 1e-30."""
    return dfl.df_to_f32(_pq_inverse_df(dfl.df(y), m2))


def _pq_eotf_df(e_df, m2: float):
    """PQ signal -> luminance, df32 in / df32 out (see pq_eotf)."""
    ehi, elo = e_df
    clamp = ehi < _f32(1e-30)
    hi = torch.clamp(ehi, min=_f32(1e-30))
    lo = torch.where(clamp, 0.0, elo)
    u = dfl.df_exp(dfl.df_mul_const(dfl.df_log((hi, lo)), 1.0 / m2))
    num = dfl.df_add(u, dfl.df_const(-C.PQ_C1))
    den = dfl.df_add(dfl.df_const(C.PQ_C2),
                     dfl.df_mul_f32(u, _f32(-C.PQ_C3)))
    nonpos = (ehi <= 0.0) | (num[0] <= 0.0)
    num = (torch.where(nonpos, 1.0, num[0]), torch.where(nonpos, 0.0, num[1]))
    den_bad = den[0] <= 0.0
    den = (torch.where(den_bad, _f32(1e-12), den[0]),
           torch.where(den_bad, 0.0, den[1]))
    lny = dfl.df_add(
        dfl.df_mul_const(dfl.df_log(dfl.df_div(num, den)), 1.0 / C.PQ_M1),
        dfl.df_const(math.log(C.PQ_LP)))
    y = dfl.df_exp(lny)
    return torch.where(nonpos, 0.0, y[0]), torch.where(nonpos, 0.0, y[1])


def pq_eotf(e: torch.Tensor, m2: float = C.PQ_M2) -> torch.Tensor:
    """PQ signal -> luminance, with the reference's clamps
    (src/color/common.py:94-129): a signal or numerator <= 0 maps to 0, a
    denominator <= 0 becomes 1e-12."""
    return dfl.df_to_f32(_pq_eotf_df(dfl.df(e), m2))


def _dot3_df(x_df, m64: np.ndarray, selected: bool = False, fuses=None):
    """df32 (..., 3) x float64 3x3 matrix -> df32 (..., 3); each constant a
    (hi, lo) pair, products and sums error-compensated (`selected` as in
    dfloat.df_mul_const).  fuses: per output j and term i, (fuse, unfused)
    for dfloat.df_mul and dfloat.partials_unfused, where the compiled
    kernel departs from df_mul_const's rule."""
    hi, lo = x_df
    outs = []
    for j in range(3):
        acc = None
        for i in range(3):
            x_i = (hi[..., i], lo[..., i])
            if fuses is None:
                term = dfl.df_mul_const(x_i, float(m64[j, i]), selected)
            else:
                fuse, unfused = fuses[j][i]
                with (dfl.partials_unfused() if unfused
                      else contextlib.nullcontext()):
                    term = dfl.df_mul(x_i, dfl.df_const(float(m64[j, i])),
                                      fuse)
            acc = term if acc is None else dfl.df_add(acc, term)
        outs.append(acc)
    return (torch.stack([o[0] for o in outs], dim=-1),
            torch.stack([o[1] for o in outs], dim=-1))


# The inverse ICtCp's second dot as XLA's kernel compiles it, per output
# j and term i: the cross product of dfloat.df_mul that LLVM fuses ("a_hi",
# "a_lo", or "" for neither, two_prod's last partial product then rounded
# too), and whether two_prod's third partial product is rounded on its
# own (dfloat.partials_unfused).  Read off jax.jit results on near-black
# pixels, where the partial products flush (`python3 tools/xla_dot_order.py
# ictcp`); elsewhere every choice gives the same bits.
_ICTCP_LMS_TO_XYZ_FUSES = (
    (("a_hi", False), ("a_hi", False), ("a_lo", False)),
    (("a_hi", False), ("a_hi", False), ("a_hi", True)),
    (("a_hi", True), ("a_hi", True), ("a_hi", False)))


def _dot3_f32_df(x: torch.Tensor, m64: np.ndarray):
    """_dot3_df of df(x) as the inverse ICtCp's first dot compiles: each
    term is dfloat.df_mul_const_f32 (its input's zero low part folded)."""
    outs = []
    for j in range(3):
        acc = None
        for i in range(3):
            term = dfl.df_mul_const_f32(x[..., i], float(m64[j, i]))
            acc = term if acc is None else dfl.df_add(acc, term)
        outs.append(acc)
    return (torch.stack([o[0] for o in outs], dim=-1),
            torch.stack([o[1] for o in outs], dim=-1))


@functools.lru_cache(maxsize=None)
def _f64_pair(name: str):
    """(M, M^-1) of a constants.py 3x3 matrix, inverted in float64 (the
    float32 inverses in constants.py cost a digit the PQ exponent then
    amplifies)."""
    m64 = getattr(C, name).astype(np.float64)
    return m64, np.linalg.inv(m64)


# ---------------------------------------------------------------------- ICtCp
def srgb_to_ictcp(rgb, tiny=True):
    """XYZ -> LMS -> PQ -> ICtCp entirely in df32, rounded once at the
    output."""
    m_lms, _ = _f64_pair("ICTCP_M_XYZ_TO_LMS")
    m_ict, _ = _f64_pair("ICTCP_M_LMSP_TO_ICTCP")
    lms = _dot3_df(dfl.df(srgb_to_xyz(rgb, tiny)), m_lms)
    lms_p = _per_channel("ictcp_fwd",
                         lambda v: _pq_inverse_df(v, C.PQ_M2), lms)
    return dfl.df_to_f32(_dot3_df(lms_p, m_ict))


def ictcp_to_srgb(ictcp, tiny=True):
    # the first contraction is in df32, whose steps always flush
    _, m_lms_inv = _f64_pair("ICTCP_M_XYZ_TO_LMS")
    _, m_ict_inv = _f64_pair("ICTCP_M_LMSP_TO_ICTCP")
    lms = _per_channel("ictcp_inv", lambda v: _pq_eotf_df(v, C.PQ_M2),
                       _dot3_f32_df(ictcp, m_ict_inv))
    xyz = dfl.df_to_f32(_dot3_df(lms, m_lms_inv,
                                 fuses=_ICTCP_LMS_TO_XYZ_FUSES))
    return xyz_to_srgb(xyz)


# ---------------------------------------------------------------------- ICaCb
def srgb_to_icacb(rgb, tiny=True):
    rgb_bar = _dot3(srgb_to_xyz(rgb, tiny), C.ICACB_M_XYZ_TO_RGBBAR)
    return _dot3(_per_channel("icacb_fwd", pq_inverse_eotf, rgb_bar),
                 C.ICACB_M_RGBP_TO_ICACB)


def icacb_to_srgb(icacb, tiny=True):
    rgb_bar = _per_channel("icacb_inv", pq_eotf,
                           _dot3(icacb, C.ICACB_M_ICACB_TO_RGBP, tiny))
    return xyz_to_srgb(_dot3(rgb_bar, C.ICACB_M_RGBBAR_TO_XYZ))


# --------------------------------------------------------------------- JzAzBz
assert (C.JZAZBZ_M_IZAZBZ_TO_LMSP[:, 0] == 1.0).all()


def srgb_to_jzazbz(rgb, tiny=True):
    """Rounded as the JAX reference is compiled for the CPU: XLA expands
    the 3x3 product of the stacked (X', Y', Z) into multiply-adds, and each
    `a*b + c` or `a*b - c*d` whose first product has no other use is one
    FMA."""
    xyz = srgb_to_xyz(rgb, tiny)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    # every product and FMA of a tiny XYZ can fall below 2**-126
    xp = ftz(fma32(x, _f32(C.JZAZBZ_B), -ftz(z * _f32(C.JZAZBZ_B - 1.0))))
    yp = ftz(fma32(y, _f32(C.JZAZBZ_G), -ftz(x * _f32(C.JZAZBZ_G - 1.0))))
    lms = _dot3_columns(xp, yp, z, C.JZAZBZ_M_XYZ_TO_LMS)
    izazbz = _dot3(_per_channel("jzazbz_fwd", lambda v: pq_inverse_eotf(
        v, m2=C.JZAZBZ_P), lms),
                   C.JZAZBZ_M_LMSP_TO_IZAZBZ)
    iz = izazbz[..., 0]
    jz = (ftz(ftz(iz * _f32(1.0 + C.JZAZBZ_D))
              / fma32(iz, _f32(C.JZAZBZ_D), 1.0))
          + _f32(-C.JZAZBZ_D0))
    return torch.stack([jz, izazbz[..., 1], izazbz[..., 2]], dim=-1)


def jzazbz_to_srgb(jab, tiny=True):
    """Rounded as the JAX reference is compiled for the CPU, where the
    inverse amplifies 1-ulp differences past 2e-6 near black: each
    `a + b*c` is one FMA, on a 2-D jab XLA drops the products by the
    all-ones first column of JZAZBZ_M_IZAZBZ_TO_LMSP (on a batched one it
    emits the whole dot), and it turns the divisions by the constants B and
    G into products by their float32 reciprocals."""
    # jz0 cancels to below 2**-126 where jab's J is about -D0, and the
    # products and sums of tiny a, b fall below it
    if tiny:
        jab = ftz(jab)
    jz0 = ftz(jab[..., 0] + C.JZAZBZ_D0)
    iz = ftz(jz0 / fma32(jz0, -_f32(C.JZAZBZ_D), _f32(1.0 + C.JZAZBZ_D)))
    m = C.JZAZBZ_M_IZAZBZ_TO_LMSP
    az, bz = jab[..., 1], jab[..., 2]
    if jab.dim() > 2:
        lms_p = _dot3(torch.stack([iz, az, bz], dim=-1), m)
    else:
        lms_p = torch.stack(
            [ftz(iz + ftz(fma32(bz, m[j, 2], ftz(az * float(m[j, 1])))))
             for j in range(3)], dim=-1)
    xyz_p = _dot3(_per_channel("jzazbz_inv", lambda v: pq_eotf(
        v, m2=C.JZAZBZ_P), lms_p), C.JZAZBZ_M_LMS_TO_XYZ)
    xp, yp, zp = xyz_p[..., 0], xyz_p[..., 1], xyz_p[..., 2]
    num = ftz(fma32(zp, _f32(C.JZAZBZ_B - 1.0), xp))
    rb = _rcp(C.JZAZBZ_B)
    x = ftz(num * rb)
    # (G - 1) * x = num * ((G - 1) * rb), the constants folded in float32
    y = ftz(ftz(fma32(num, _f32(_f32(C.JZAZBZ_G - 1.0) * rb), yp))
            * _rcp(C.JZAZBZ_G))
    return linear_to_srgb(_dot3_columns(x, y, zp, C.M_XYZ_TO_LINEAR_RGB))
