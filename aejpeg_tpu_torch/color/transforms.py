"""Color transforms on (..., 3) float32 tensors.

Counterpart of the JAX package's color/transforms.py for the non-PQ spaces
(sRGB <-> YCbCr, YCoCg, YCoCg-R, XYZ, OKLAB).  Every 3x3 contraction is an
explicit left-to-right sum of three products, so its rounding does not
depend on which matmul kernel a backend picks.

The PQ spaces (ICtCp, ICaCb, JzAzBz) are not ported yet: they raise
NotImplementedError.  Their port runs the PQ chain in native float64 (the
JAX package's double-float32 arithmetic only worked around a TPU without
f64).
"""

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


# ------------------------------------------------------------ PQ (not ported)
def _pq_not_ported(*_args):
    raise NotImplementedError(
        "the PQ color spaces (ICtCp, ICaCb, JzAzBz) are not ported to "
        "aejpeg_tpu_torch yet; see ROADMAP.md Queue 1, 'PQ colour spaces "
        "in float64'")


srgb_to_ictcp = ictcp_to_srgb = _pq_not_ported
srgb_to_icacb = icacb_to_srgb = _pq_not_ported
srgb_to_jzazbz = jzazbz_to_srgb = _pq_not_ported
