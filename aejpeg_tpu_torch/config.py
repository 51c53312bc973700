"""Codec configuration.

Mirrors the reference's `JpegCompressionSettings` (src/jpeg/jpeg.py:36-174):
per-color-space chroma downsampling ratios and base quantization matrices,
plus quality/block-size ranges.  Implemented as a frozen dataclass so configs
are hashable (usable as static jit args).
"""

import dataclasses
from typing import Dict, Tuple

import numpy as np

from .utils import block_sizes_in_range, quality_factor

# Standard JPEG base quantization matrices (Annex K) —
# reference src/jpeg/jpeg.py:40-59.
LUMA_QUANT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float32)
CHROMA_QUANT = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], dtype=np.float32)

# Per-space (H_div, W_div) subsampling per layer and per-layer base matrices —
# reference src/jpeg/jpeg.py:62-147.  4:1:1 for ICaCb/ICtCp, 4:2:0 otherwise.
_RATIO_420 = ((1, 1), (2, 2), (2, 2))
_RATIO_411 = ((1, 1), (1, 4), (1, 4))
COLOR_SPACE_SETTINGS: Dict[str, Dict] = {
    "ICaCb": {"downsampling_ratios": _RATIO_411},
    "ICtCp": {"downsampling_ratios": _RATIO_411},
    "JzAzBz": {"downsampling_ratios": _RATIO_420},
    "OKLAB": {"downsampling_ratios": _RATIO_420},
    "YCbCr": {"downsampling_ratios": _RATIO_420},
    "YCoCg": {"downsampling_ratios": _RATIO_420},
    "YCoCg-R": {"downsampling_ratios": _RATIO_420},
}
for _cfg in COLOR_SPACE_SETTINGS.values():
    _cfg["quantization_matrices"] = (LUMA_QUANT, CHROMA_QUANT, CHROMA_QUANT)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Compression settings (reference defaults: src/jpeg/jpeg.py:150-155).

    entropy_level: zlib level for the coefficient streams.  9 matches the
    reference's output byte-for-byte (src/jpeg/jpeg.py:590); any level
    produces a spec-valid stream (the decoder just inflates).  -1 selects
    the native SPARSE encoder (native/entropy.cpp): a hand-rolled deflate
    specialized for mostly-zero int32 data, ~10x zlib-9 throughput at
    ~1.2x larger output — the production default for throughput
    deployments.  Not serialized: decode is level-agnostic.
    """
    color_space: str = "YCoCg"
    quality_range: Tuple[int, int] = (40, 80)
    block_size_range: Tuple[int, int] = (4, 64)
    entropy_level: int = 9

    def __post_init__(self):
        if self.color_space not in COLOR_SPACE_SETTINGS:
            raise ValueError(f"Unsupported color space: {self.color_space}")
        lo, hi = self.block_size_range
        if lo < 1 or hi < lo or (lo & (lo - 1)) or (hi & (hi - 1)):
            raise ValueError(
                f"block_size_range must be (pow2_min <= pow2_max): {lo, hi}")

    @property
    def downsampling_ratios(self) -> Tuple[Tuple[int, int], ...]:
        return COLOR_SPACE_SETTINGS[self.color_space]["downsampling_ratios"]

    @property
    def quantization_matrices(self):
        return COLOR_SPACE_SETTINGS[self.color_space]["quantization_matrices"]

    @property
    def block_sizes(self):
        return block_sizes_in_range(self.block_size_range)

    def quality_for(self, block_size: int) -> int:
        return quality_factor(block_size, self.block_size_range,
                              self.quality_range)

    def layer_shapes(self, layer_shape: Tuple[int, int]):
        """Downsampled (H, W) per layer via integer division
        (reference src/jpeg/jpeg.py:676-686)."""
        h, w = layer_shape
        return tuple((h // r[0], w // r[1]) for r in self.downsampling_ratios)

    @property
    def num_layers(self) -> int:
        return 3
