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
- the code runs with denormals flushed to zero (`ftz`).
The PQ transfer function runs on double-float32 pairs as the JAX
package's does (ops/dfloat.py), with the same clamps at the same places.

Not mirrored: XLA flushes every subnormal intermediate, the port only
those of the transfer functions, powf and df_exp.  Inputs whose
intermediates fall below 2**-126 (a PQ luminance in (0, 1e-30], sRGB
values below about 1e-35) may differ in the last bit.
"""

import functools
import math

import numpy as np
import torch

from ..ops import dfloat as dfl
from ..ops.libm import ftz, powf
from ..ops.rounding import fma32
from . import constants as C


def _dot3_rows(x: torch.Tensor, m: np.ndarray, fused) -> torch.Tensor:
    """out_j = x0*m[j,0] + x1*m[j,1] + x2*m[j,2], left to right; for j in
    `fused` each `+ x_i*m[j,i]` is one FMA (ops/rounding.py), otherwise
    every product and sum rounds."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack(
        [fma32(x2, m[j, 2], fma32(x1, m[j, 1], x0 * float(m[j, 0])))
         if j in fused else
         x0 * float(m[j, 0]) + x1 * float(m[j, 1]) + x2 * float(m[j, 2])
         for j in range(3)], dim=-1)


def _dot3(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """(..., 3) @ m.T, rounded as XLA's CPU dot emitter does it.  On a 2-D
    x every product is fused.  A batched x XLA flattens to rows, with m
    transposed, and its loop over 8 rows at a time fuses only out_2's
    products; the rows past the last multiple of 8 take a scalar loop that
    fuses them all."""
    m = np.asarray(m, np.float32)
    if x.dim() == 2:
        return _dot3_rows(x, m, range(3))
    flat = x.reshape(-1, 3)
    body = flat.shape[0] - flat.shape[0] % 8
    out = _dot3_rows(flat[:body], m, (2,))
    if body < flat.shape[0]:
        out = torch.cat([out, _dot3_rows(flat[body:], m, range(3))])
    return out.reshape(x.shape)


def _dot3_columns(x0, x1, x2, m: np.ndarray) -> torch.Tensor:
    """(x0, x1, x2) @ m.T for three separately computed columns.  On
    columns of a 2-D x XLA expands that product into multiply-adds,
    x0*m[j,0] + x1*m[j,1] + x2*m[j,2], and fuses the first product of each
    add (unlike `_dot3`); on batched columns it emits the stacked dot."""
    if x0.dim() > 1:
        return _dot3(torch.stack([x0, x1, x2], dim=-1), m)
    return torch.stack(
        [fma32(x2, m[j, 2], fma32(x0, m[j, 0], x1 * float(m[j, 1])))
         for j in range(3)], dim=-1)


# --------------------------------------------------------------- sRGB <-> lin
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
    return torch.clamp(srgb, 0.0, 1.0)


# ------------------------------------------------------------------ 3x3 spaces
def srgb_to_ycbcr(rgb):
    return _dot3(rgb, C.M_SRGB_TO_YCBCR)


def ycbcr_to_srgb(ycc):
    return torch.clamp(_dot3(ycc, C.M_YCBCR_TO_SRGB), 0.0, 1.0)


def srgb_to_ycocg(rgb):
    return _dot3(rgb, C.M_SRGB_TO_YCOCG)


def ycocg_to_srgb(x):
    return torch.clamp(_dot3(x, C.M_YCOCG_TO_SRGB), 0.0, 1.0)


def srgb_to_ycocg_r(rgb):
    return _dot3(rgb, C.M_SRGB_TO_YCOCG_R)


def ycocg_r_to_srgb(x):
    return torch.clamp(_dot3(x, C.M_YCOCG_R_TO_SRGB), 0.0, 1.0)


def srgb_to_xyz(rgb):
    return _dot3(srgb_to_linear(rgb), C.M_LINEAR_RGB_TO_XYZ)


def xyz_to_srgb(xyz):
    return linear_to_srgb(_dot3(xyz, C.M_XYZ_TO_LINEAR_RGB))


# ---------------------------------------------------------------------- OKLAB
def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """jnp.cbrt as XLA compiles it for the CPU:
    copysign(powf(|x|, f32(1/3)), x)."""
    return torch.copysign(powf(x.abs(), _f32(1 / 3)), x)


def srgb_to_oklab(rgb):
    lms = _dot3(srgb_to_xyz(rgb), C.OKLAB_M_XYZ_TO_LMS)
    return _dot3(_cbrt(lms), C.OKLAB_M_LMSP_TO_LAB)


def oklab_to_srgb(lab):
    lms_p = _dot3(lab, C.OKLAB_M_LAB_TO_LMSP)
    lms = lms_p * lms_p * lms_p
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
    e = err + m[1]
    hi = s + e
    return hi, e - (hi - (a + dfl.df_mul_f32(t, c)[0]))


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


def _dot3_df(x_df, m64: np.ndarray, selected: bool = False):
    """df32 (..., 3) x float64 3x3 matrix -> df32 (..., 3); each constant a
    (hi, lo) pair, products and sums error-compensated (`selected` as in
    dfloat.df_mul_const)."""
    hi, lo = x_df
    outs = []
    for j in range(3):
        acc = None
        for i in range(3):
            term = dfl.df_mul_const((hi[..., i], lo[..., i]), float(m64[j, i]),
                                    selected)
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
def srgb_to_ictcp(rgb):
    """XYZ -> LMS -> PQ -> ICtCp entirely in df32, rounded once at the
    output."""
    m_lms, _ = _f64_pair("ICTCP_M_XYZ_TO_LMS")
    m_ict, _ = _f64_pair("ICTCP_M_LMSP_TO_ICTCP")
    lms = _dot3_df(dfl.df(srgb_to_xyz(rgb)), m_lms)
    return dfl.df_to_f32(_dot3_df(_pq_inverse_df(lms, C.PQ_M2), m_ict))


def ictcp_to_srgb(ictcp):
    _, m_lms_inv = _f64_pair("ICTCP_M_XYZ_TO_LMS")
    _, m_ict_inv = _f64_pair("ICTCP_M_LMSP_TO_ICTCP")
    lms = _pq_eotf_df(_dot3_df(dfl.df(ictcp), m_ict_inv), C.PQ_M2)
    xyz = dfl.df_to_f32(_dot3_df(lms, m_lms_inv, selected=True))
    return xyz_to_srgb(xyz)


# ---------------------------------------------------------------------- ICaCb
def srgb_to_icacb(rgb):
    rgb_bar = _dot3(srgb_to_xyz(rgb), C.ICACB_M_XYZ_TO_RGBBAR)
    return _dot3(pq_inverse_eotf(rgb_bar), C.ICACB_M_RGBP_TO_ICACB)


def icacb_to_srgb(icacb):
    rgb_bar = pq_eotf(_dot3(icacb, C.ICACB_M_ICACB_TO_RGBP))
    return xyz_to_srgb(_dot3(rgb_bar, C.ICACB_M_RGBBAR_TO_XYZ))


# --------------------------------------------------------------------- JzAzBz
assert (C.JZAZBZ_M_IZAZBZ_TO_LMSP[:, 0] == 1.0).all()


def srgb_to_jzazbz(rgb):
    """Rounded as the JAX reference is compiled for the CPU: XLA expands
    the 3x3 product of the stacked (X', Y', Z) into multiply-adds, and each
    `a*b + c` or `a*b - c*d` whose first product has no other use is one
    FMA."""
    xyz = srgb_to_xyz(rgb)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    xp = fma32(x, _f32(C.JZAZBZ_B), -(z * _f32(C.JZAZBZ_B - 1.0)))
    yp = fma32(y, _f32(C.JZAZBZ_G), -(x * _f32(C.JZAZBZ_G - 1.0)))
    lms = _dot3_columns(xp, yp, z, C.JZAZBZ_M_XYZ_TO_LMS)
    izazbz = _dot3(pq_inverse_eotf(lms, m2=C.JZAZBZ_P),
                   C.JZAZBZ_M_LMSP_TO_IZAZBZ)
    iz = izazbz[..., 0]
    jz = ((iz * _f32(1.0 + C.JZAZBZ_D)) / fma32(iz, _f32(C.JZAZBZ_D), 1.0)
          + _f32(-C.JZAZBZ_D0))
    return torch.stack([jz, izazbz[..., 1], izazbz[..., 2]], dim=-1)


def jzazbz_to_srgb(jab):
    """Rounded as the JAX reference is compiled for the CPU, where the
    inverse amplifies 1-ulp differences past 2e-6 near black: each
    `a + b*c` is one FMA, on a 2-D jab XLA drops the products by the
    all-ones first column of JZAZBZ_M_IZAZBZ_TO_LMSP (on a batched one it
    emits the whole dot), and it turns the divisions by the constants B and
    G into products by their float32 reciprocals."""
    jz0 = jab[..., 0] + C.JZAZBZ_D0
    iz = jz0 / fma32(jz0, -_f32(C.JZAZBZ_D), _f32(1.0 + C.JZAZBZ_D))
    m = C.JZAZBZ_M_IZAZBZ_TO_LMSP
    az, bz = jab[..., 1], jab[..., 2]
    if jab.dim() > 2:
        lms_p = _dot3(torch.stack([iz, az, bz], dim=-1), m)
    else:
        lms_p = torch.stack([iz + fma32(bz, m[j, 2], az * float(m[j, 1]))
                             for j in range(3)], dim=-1)
    xyz_p = _dot3(pq_eotf(lms_p, m2=C.JZAZBZ_P), C.JZAZBZ_M_LMS_TO_XYZ)
    xp, yp, zp = xyz_p[..., 0], xyz_p[..., 1], xyz_p[..., 2]
    num = fma32(zp, _f32(C.JZAZBZ_B - 1.0), xp)
    rb = _rcp(C.JZAZBZ_B)
    x = num * rb
    # (G - 1) * x = num * ((G - 1) * rb), the constants folded in float32
    y = fma32(num, _f32(_f32(C.JZAZBZ_G - 1.0) * rb), yp) * _rcp(C.JZAZBZ_G)
    return linear_to_srgb(_dot3_columns(x, y, zp, C.M_XYZ_TO_LINEAR_RGB))
