"""Image loading/saving (float32 [0,1] HWC), format-normalized.

Parity with the reference Image wrapper (src/image/image.py:26-149):
grayscale is stacked to 3 channels, RGBA drops alpha, save scales by 255 and
casts to uint8.  `imageio` is imported inside `load`/`save` only, so the
codec runs where it is not installed.
"""

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ImageData:
    data: np.ndarray                  # float32 [0,1], (H, W, 3)
    original_shape: Tuple[int, ...]
    extension: Optional[str]
    # True when `data` is exactly uint8/255 (set by the loader for 8-bit
    # sources).  Lets encode_batch upload 1 byte/sample without the full
    # round-trip equality check it otherwise runs; None = unknown (check).
    u8_exact: Optional[bool] = None

    @classmethod
    def load(cls, path: str) -> "ImageData":
        import imageio.v3 as iio
        extension = os.path.splitext(path)[1]
        raw = iio.imread(path)
        img = raw.astype(np.float32) / 255.0
        if img.ndim == 2:
            img = np.stack((img,) * 3, axis=-1)
        elif img.ndim == 3 and img.shape[2] == 3:
            pass
        elif img.ndim == 3 and img.shape[2] == 4:
            img = img[:, :, :3]
        else:
            raise ValueError(f"Unsupported image format: {img.shape}")
        return cls(img, img.shape, extension,
                   u8_exact=(raw.dtype == np.uint8))

    @classmethod
    def from_array(cls, data: np.ndarray,
                   shape: Optional[Tuple[int, ...]] = None,
                   extension: Optional[str] = None) -> "ImageData":
        if shape is None:
            shape = data.shape
        return cls(np.asarray(data, np.float32).reshape(shape), shape,
                   extension)

    def save(self, path: str) -> None:
        import imageio.v3 as iio
        iio.imwrite(path, self.get_uint8())

    def get_uint8(self) -> np.ndarray:
        return (self.data * 255).astype(np.uint8)

    def get_flattened(self) -> np.ndarray:
        return self.data.reshape(-1, self.original_shape[-1])

    def copy(self) -> "ImageData":
        return ImageData(self.data.copy(), self.original_shape,
                         self.extension)

    @property
    def raw_rgb_bytes(self) -> int:
        """Raw uint8 RGB byte count — the compression-ratio denominator
        (reference uses PIL tobytes(): src/gui/main_frame.py:148-151)."""
        return int(np.prod(self.original_shape))
