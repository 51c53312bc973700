"""Color transforms on (..., 3) float32 tensors.

Counterpart of the JAX package's color/transforms.py (sRGB <-> YCbCr,
YCoCg, YCoCg-R, XYZ, OKLAB, ICtCp, ICaCb, JzAzBz).  Every 3x3 contraction
is an explicit left-to-right sum of three products, so its rounding does
not depend on which matmul kernel a backend picks.

The PQ transfer function runs in native float64 where the JAX package
carries double-float32 pairs (ops/dfloat.py, a workaround for a TPU without
f64), with the same clamps and at the same places: its m2 exponent (78.84,
134.03 for JzAzBz) amplifies float32 rounding past the 1e-4 round-trip
bound.  ICtCp runs XYZ -> LMS -> PQ -> ICtCp entirely in float64 and rounds
once at the output; ICaCb and JzAzBz keep their float32 contractions and
run only the PQ transfer in float64.
"""

import functools
import math

import numpy as np
import torch

from ..ops.rounding import divide, fma32
from . import constants as C


def _dot3(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """(..., 3) @ m.T, left to right: out_j = x0*m[j,0] + x1*m[j,1] +
    x2*m[j,2], with each `+ x_i*m[j,i]` a single-rounding FMA: the order
    and rounding of the JAX reference's 3-term contraction
    (ops/rounding.py)."""
    mt = torch.as_tensor(np.asarray(m, np.float32), device=x.device)
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack(
        [fma32(x2, mt[j, 2], fma32(x1, mt[j, 1], x0 * mt[j, 0]))
         for j in range(3)], dim=-1)


# --------------------------------------------------------------- sRGB <-> lin
def srgb_to_linear(v: torch.Tensor) -> torch.Tensor:
    """Inverse sRGB transfer function (reference src/color/common.py:34-60)."""
    return torch.where(
        v <= 0.04045, divide(v, 12.92),
        divide(torch.clamp(v, min=0.04045) + 0.055, 1.055) ** 2.4)


def linear_to_srgb(v: torch.Tensor) -> torch.Tensor:
    """Forward sRGB transfer + clip to [0,1] (src/color/common.py:62-92)."""
    srgb = torch.where(
        v <= 0.0031308, v * 12.92,
        1.055 * torch.clamp(v, min=0.0031308) ** (1.0 / 2.4) - 0.055)
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
    """Real cube root, defined for negative inputs like jnp.cbrt."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def srgb_to_oklab(rgb):
    lms = _dot3(srgb_to_xyz(rgb), C.OKLAB_M_XYZ_TO_LMS)
    return _dot3(_cbrt(lms), C.OKLAB_M_LMSP_TO_LAB)


def oklab_to_srgb(lab):
    lms_p = _dot3(lab, C.OKLAB_M_LAB_TO_LMSP)
    lms = lms_p * lms_p * lms_p
    return xyz_to_srgb(_dot3(lms, C.OKLAB_M_LMS_TO_XYZ))


# ------------------------------------------------------------------------ PQ
def _pq_inverse64(y: torch.Tensor, m2: float) -> torch.Tensor:
    """Luminance -> PQ signal in float64 (src/color/common.py:131-159):
    y <= 0 maps to c1**m2, and the base is floored at 1e-30."""
    t = (torch.clamp(y, min=1e-30) * (1.0 / C.PQ_LP)) ** C.PQ_M1
    e = ((C.PQ_C1 + t * C.PQ_C2) / (1.0 + t * C.PQ_C3)) ** m2
    return torch.where(y <= 0.0, float(C.PQ_C1) ** m2, e)


def _pq_eotf64(e: torch.Tensor, m2: float) -> torch.Tensor:
    """PQ signal -> luminance in float64, with the reference's clamps
    (src/color/common.py:94-129): a signal or numerator <= 0 maps to 0, a
    denominator <= 0 becomes 1e-12; the base is floored at 1e-30."""
    u = torch.clamp(e, min=1e-30) ** (1.0 / m2)
    num = u - C.PQ_C1
    den = C.PQ_C2 - u * C.PQ_C3
    nonpos = (e <= 0.0) | (num <= 0.0)
    num = torch.where(nonpos, 1.0, num)
    den = torch.where(den <= 0.0, float(np.float32(1e-12)), den)
    y = torch.exp(torch.log(num / den) * (1.0 / C.PQ_M1) + math.log(C.PQ_LP))
    return torch.where(nonpos, 0.0, y)


def pq_inverse_eotf(y: torch.Tensor, m2: float = C.PQ_M2) -> torch.Tensor:
    """Luminance -> PQ signal: float32 in, float64 inside, float32 out."""
    return _pq_inverse64(y.to(torch.float64), m2).to(torch.float32)


def pq_eotf(e: torch.Tensor, m2: float = C.PQ_M2) -> torch.Tensor:
    """PQ signal -> luminance: float32 in, float64 inside, float32 out."""
    return _pq_eotf64(e.to(torch.float64), m2).to(torch.float32)


def _dot3_64(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """float64 (..., 3) @ m.T (m float64), summed left to right."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([x0 * float(m[j, 0]) + x1 * float(m[j, 1])
                        + x2 * float(m[j, 2]) for j in range(3)], dim=-1)


@functools.lru_cache(maxsize=None)
def _f64_pair(name: str):
    """(M, M^-1) of a constants.py 3x3 matrix, inverted in float64 (the
    float32 inverses in constants.py cost a digit the PQ exponent then
    amplifies)."""
    m64 = getattr(C, name).astype(np.float64)
    return m64, np.linalg.inv(m64)


# ---------------------------------------------------------------------- ICtCp
def srgb_to_ictcp(rgb):
    m_lms, _ = _f64_pair("ICTCP_M_XYZ_TO_LMS")
    m_ict, _ = _f64_pair("ICTCP_M_LMSP_TO_ICTCP")
    lms = _dot3_64(srgb_to_xyz(rgb).to(torch.float64), m_lms)
    return _dot3_64(_pq_inverse64(lms, C.PQ_M2), m_ict).to(torch.float32)


def ictcp_to_srgb(ictcp):
    _, m_lms_inv = _f64_pair("ICTCP_M_XYZ_TO_LMS")
    _, m_ict_inv = _f64_pair("ICTCP_M_LMSP_TO_ICTCP")
    lms_p = _dot3_64(ictcp.to(torch.float64), m_ict_inv)
    xyz = _dot3_64(_pq_eotf64(lms_p, C.PQ_M2), m_lms_inv)
    return xyz_to_srgb(xyz.to(torch.float32))


# ---------------------------------------------------------------------- ICaCb
def srgb_to_icacb(rgb):
    rgb_bar = _dot3(srgb_to_xyz(rgb), C.ICACB_M_XYZ_TO_RGBBAR)
    return _dot3(pq_inverse_eotf(rgb_bar), C.ICACB_M_RGBP_TO_ICACB)


def icacb_to_srgb(icacb):
    rgb_bar = pq_eotf(_dot3(icacb, C.ICACB_M_ICACB_TO_RGBP))
    return xyz_to_srgb(_dot3(rgb_bar, C.ICACB_M_RGBBAR_TO_XYZ))


# --------------------------------------------------------------------- JzAzBz
_F32 = np.float32
assert (C.JZAZBZ_M_IZAZBZ_TO_LMSP[:, 0] == 1.0).all()


def srgb_to_jzazbz(rgb):
    xyz = srgb_to_xyz(rgb)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    xp = C.JZAZBZ_B * x - (C.JZAZBZ_B - 1.0) * z
    yp = C.JZAZBZ_G * y - (C.JZAZBZ_G - 1.0) * x
    lms = _dot3(torch.stack([xp, yp, z], dim=-1), C.JZAZBZ_M_XYZ_TO_LMS)
    lms_p = pq_inverse_eotf(lms, m2=C.JZAZBZ_P)
    izazbz = _dot3(lms_p, C.JZAZBZ_M_LMSP_TO_IZAZBZ)
    iz = izazbz[..., 0]
    jz = (((1.0 + C.JZAZBZ_D) * iz) / (1.0 + C.JZAZBZ_D * iz)
          - C.JZAZBZ_D0)
    return torch.stack([jz, izazbz[..., 1], izazbz[..., 2]], dim=-1)


def jzazbz_to_srgb(jab):
    """Rounded as the JAX reference is compiled for the CPU, where the
    inverse amplifies 1-ulp differences past 2e-6 near black: each
    `a + b*c` is one FMA, XLA drops the products by the all-ones first
    column of JZAZBZ_M_IZAZBZ_TO_LMSP, and it turns the divisions by the
    constants B and G into products by their float32 reciprocals."""
    jz0 = jab[..., 0] + C.JZAZBZ_D0
    iz = jz0 / fma32(jz0, -_F32(C.JZAZBZ_D), _F32(1.0 + C.JZAZBZ_D))
    m = C.JZAZBZ_M_IZAZBZ_TO_LMSP
    az, bz = jab[..., 1], jab[..., 2]
    lms_p = torch.stack([iz + fma32(bz, m[j, 2], az * float(m[j, 1]))
                         for j in range(3)], dim=-1)
    xyz_p = _dot3(pq_eotf(lms_p, m2=C.JZAZBZ_P), C.JZAZBZ_M_LMS_TO_XYZ)
    xp, yp, zp = xyz_p[..., 0], xyz_p[..., 1], xyz_p[..., 2]
    num = fma32(zp, _F32(C.JZAZBZ_B - 1.0), xp)
    rb, rg = 1 / _F32(C.JZAZBZ_B), 1 / _F32(C.JZAZBZ_G)
    x = num * rb
    # (G - 1) * x = num * ((G - 1) * rb), the constants folded in float32
    y = fma32(num, _F32(C.JZAZBZ_G - 1.0) * rb, yp) * rg
    return xyz_to_srgb(torch.stack([x, y, zp], dim=-1))
