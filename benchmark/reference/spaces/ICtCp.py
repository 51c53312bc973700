"""BT.2100 ICtCp, as the reference codec defines it (src/color/ictcp.py:
142-163 of fevzibabaoglu/adaptive-edge-aware-jpeg), with 4:1:1 chroma
(src/jpeg/jpeg.py:62-147).

Forward: sRGB EOTF -> linear RGB -> XYZ (D65) -> LMS -> PQ inverse EOTF
(SMPTE ST 2084) -> ICtCp.  Inverse: the same steps in reverse, clipped to
[0, 1].  The LMS values enter the PQ curve divided by PQ_LP = 10000: XYZ's
Y of 1 (sRGB white) is 1 cd/m2, there is no reference white.

Precision.  `prec="reference"`: every step in float64, the layers rounded
to float32 once at the end of `from_srgb` (the codec defines its layers at
float32); `to_srgb` stays in float64.  `prec="tf32"` (the control): each
matrix product takes operands rounded to TF32 and sums in float32, and the
transfer functions run in plain float32 (`torch.pow`).

Where this departs from the codec under test (its color/transforms.py,
which follows the JAX package as XLA compiles it for the CPU):
- it computes the sRGB EOTF and XYZ in float64; the codec in float32
  (glibc's powf, FMAs, products by float32 reciprocals, flush to zero),
  then LMS, PQ and ICtCp in double-float32 from the float32 XYZ;
- the clamps sit at the same places, tested on float64 values where the
  codec tests the high part of its pairs: forward, LMS <= 0 gives
  C1**M2 and LMS is floored at 1e-30; inverse, the signal is floored at
  1e-30, a signal or numerator <= 0 gives 0 and a denominator <= 0 is
  1e-12;
- the matrices are the float32 values of the published constants, the
  LMS and ICtCp inverses inverted in float64, as the codec has them; the
  XYZ -> linear RGB matrix is the published 7-digit one (as the codec's
  xyz_to_srgb), which inverts RGB -> XYZ to about 2e-7 only.
"""

import numpy as np
import torch

from ..codec import _dtype, tf32

MIDPOINTS = [0.07497266, -0.0008235276, 0.023989676]
SCALES = [1693.9674, 1133.9044, 1694.004]
DOWNSAMPLING = [(1, 1), (1, 4), (1, 4)]


def _f32(m) -> np.ndarray:
    return np.asarray(m, np.float64).astype(np.float32).astype(np.float64)


RGB_TO_XYZ = _f32([[0.4124564, 0.3575761, 0.1804375],
                   [0.2126729, 0.7151522, 0.0721750],
                   [0.0193339, 0.1191920, 0.9503041]])
XYZ_TO_RGB = _f32([[3.2404542, -1.5371385, -0.4985314],
                   [-0.9692660, 1.8760108, 0.0415560],
                   [0.0556434, -0.2040259, 1.0572252]])
XYZ_TO_LMS = _f32([[0.3592, 0.6976, -0.0358],
                   [-0.1922, 1.1004, 0.0755],
                   [0.0070, 0.0749, 0.8434]])
LMSP_TO_ICTCP = _f32([[0.5000, 0.5000, 0.0000],
                      [1.6137, -3.3234, 1.7097],
                      [4.3781, -4.2455, -0.1325]])
LMS_TO_XYZ = np.linalg.inv(XYZ_TO_LMS)
ICTCP_TO_LMSP = np.linalg.inv(LMSP_TO_ICTCP)

PQ_C1 = 3424 / 2 ** 12
PQ_C2 = 2413 / 2 ** 7
PQ_C3 = 2392 / 2 ** 7
PQ_M1 = 2610 / 2 ** 14
PQ_M2 = 2523 / 2 ** 5
PQ_LP = 10000.0


def _dot(x: torch.Tensor, m: np.ndarray, prec: str) -> torch.Tensor:
    """(..., 3) @ m.T, summed left to right in x's dtype; under the
    control both operands rounded to TF32."""
    if prec == "tf32":
        x = tf32(x)
        m = tf32(torch.tensor(m, dtype=torch.float32)).double().numpy()
    return torch.stack([(x[..., 0] * float(m[j, 0])
                         + x[..., 1] * float(m[j, 1]))
                        + x[..., 2] * float(m[j, 2]) for j in range(3)], -1)


def _pq_inverse_eotf(y: torch.Tensor) -> torch.Tensor:
    """Luminance -> PQ signal."""
    t = (torch.clamp(y, min=1e-30) / PQ_LP) ** PQ_M1
    e = ((PQ_C1 + PQ_C2 * t) / (1.0 + PQ_C3 * t)) ** PQ_M2
    return torch.where(y <= 0, PQ_C1 ** PQ_M2, e)


def _pq_eotf(e: torch.Tensor) -> torch.Tensor:
    """PQ signal -> luminance."""
    u = torch.clamp(e, min=1e-30) ** (1.0 / PQ_M2)
    num = u - PQ_C1
    den = PQ_C2 - PQ_C3 * u
    nonpos = (e <= 0) | (num <= 0)
    den = torch.where(den <= 0, 1e-12, den)
    y = torch.where(nonpos, 1.0, num / den) ** (1.0 / PQ_M1) * PQ_LP
    return torch.where(nonpos, 0.0, y)


def forward(x: torch.Tensor, prec: str) -> torch.Tensor:
    """(..., 3) sRGB in [0, 1] -> ICtCp, float64 (float32 under the
    control)."""
    v = x.to(_dtype(prec))
    lin = torch.where(v <= 0.04045, v / 12.92,
                      ((torch.clamp(v, min=0.04045) + 0.055) / 1.055) ** 2.4)
    lms = _dot(_dot(lin, RGB_TO_XYZ, prec), XYZ_TO_LMS, prec)
    return _dot(_pq_inverse_eotf(lms), LMSP_TO_ICTCP, prec)


def from_srgb(x: torch.Tensor, prec: str) -> torch.Tensor:
    """The codec's layers: `forward` rounded to float32."""
    return forward(x, prec).to(torch.float32)


def to_srgb(ictcp: torch.Tensor, prec: str) -> torch.Tensor:
    """(..., 3) ICtCp -> sRGB in [0, 1], float64 (float32 under the
    control)."""
    lms = _pq_eotf(_dot(ictcp.to(_dtype(prec)), ICTCP_TO_LMSP, prec))
    lin = _dot(_dot(lms, LMS_TO_XYZ, prec), XYZ_TO_RGB, prec)
    srgb = torch.where(
        lin <= 0.0031308, lin * 12.92,
        1.055 * torch.clamp(lin, min=0.0031308) ** (1 / 2.4) - 0.055)
    return torch.clamp(srgb, 0.0, 1.0)
