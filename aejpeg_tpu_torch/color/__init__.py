"""Color engine: registry, conversion dispatch, normalization.

Same API as the JAX package's `color` package: `convert(from_space,
to_space, data)` with sRGB as one endpoint, `normalization_constants`,
`apply_normalization`, `get_color_spaces()`, on (..., 3) float32 tensors.
"""

from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

from . import constants as C
from . import transforms as T


class ColorSpaceDef(NamedTuple):
    from_srgb: Callable
    to_srgb: Callable
    midpoints: np.ndarray  # (3,) float32
    scales: np.ndarray     # (3,) float32


REGISTRY: Dict[str, ColorSpaceDef] = {
    "ICaCb": ColorSpaceDef(T.srgb_to_icacb, T.icacb_to_srgb,
                           C.ICACB_MIDPOINTS, C.ICACB_SCALES),
    "ICtCp": ColorSpaceDef(T.srgb_to_ictcp, T.ictcp_to_srgb,
                           C.ICTCP_MIDPOINTS, C.ICTCP_SCALES),
    "JzAzBz": ColorSpaceDef(T.srgb_to_jzazbz, T.jzazbz_to_srgb,
                            C.JZAZBZ_MIDPOINTS, C.JZAZBZ_SCALES),
    "OKLAB": ColorSpaceDef(T.srgb_to_oklab, T.oklab_to_srgb,
                           C.OKLAB_MIDPOINTS, C.OKLAB_SCALES),
    "YCbCr": ColorSpaceDef(T.srgb_to_ycbcr, T.ycbcr_to_srgb,
                           C.YCBCR_MIDPOINTS, C.YCBCR_SCALES),
    "XYZ": ColorSpaceDef(T.srgb_to_xyz, T.xyz_to_srgb,
                         C.XYZ_MIDPOINTS, C.XYZ_SCALES),
    "YCoCg": ColorSpaceDef(T.srgb_to_ycocg, T.ycocg_to_srgb,
                           C.YCOCG_MIDPOINTS, C.YCOCG_SCALES),
    "YCoCg-R": ColorSpaceDef(T.srgb_to_ycocg_r, T.ycocg_r_to_srgb,
                             C.YCOCG_R_MIDPOINTS, C.YCOCG_R_SCALES),
}


def get_color_spaces() -> List[str]:
    """Public (user-selectable) spaces; sRGB and XYZ are internal endpoints."""
    return sorted(set(REGISTRY) - {"XYZ"})


def convert(from_space: str, to_space: str, data: torch.Tensor,
            tiny: bool = True) -> torch.Tensor:
    """Convert (..., 3) float32 data; one endpoint must be sRGB.  tiny=False
    promises that every value is 0 or at least about 2**-100 in magnitude
    (color/transforms.py)."""
    spaces = set(REGISTRY) | {"sRGB"}
    if from_space not in spaces or to_space not in spaces:
        raise ValueError(f"Invalid color space: {from_space} -> {to_space}")
    if from_space != "sRGB" and to_space != "sRGB":
        raise ValueError("One of the color spaces must be sRGB.")
    if from_space == to_space:
        return data
    if from_space == "sRGB":
        return REGISTRY[to_space].from_srgb(data, tiny)
    return REGISTRY[from_space].to_srgb(data, tiny)


def normalization_constants(color_space: str):
    """(midpoints, scales) float32 (3,) arrays mapping each channel into
    ~[-127, 127]."""
    if color_space == "sRGB":
        return (np.zeros(3, np.float32), np.ones(3, np.float32))
    d = REGISTRY[color_space]
    return d.midpoints, d.scales


def apply_normalization(color_space: str, data: torch.Tensor,
                        inverse: bool) -> torch.Tensor:
    """(x - mid) * scale, or its inverse."""
    mid, scale = normalization_constants(color_space)
    mid = torch.as_tensor(mid, device=data.device)
    scale = torch.as_tensor(scale, device=data.device)
    if inverse:
        return data / scale + mid
    return (data - mid) * scale


__all__ = ["REGISTRY", "ColorSpaceDef", "get_color_spaces", "convert",
           "normalization_constants", "apply_normalization",
           "constants", "transforms"]
