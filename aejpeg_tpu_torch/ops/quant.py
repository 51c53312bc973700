"""Quantization tables and quantize/dequantize.

Table derivation matches the reference exactly (src/jpeg/jpeg.py:707-724):
  scale = 5000/q if q < 50 else 200 - 2q
  M' = floor((scale * M8 + 50) / 100)         (float64)
  Q  = clip(resize_INTER_LINEAR(M', s x s), 1, inf).astype(int32)
Per-(layer, size) quality comes from the log interpolation in
utils.quality_factor (src/jpeg/jpeg.py:688-705).

On the device, quantize is round(y*hi + y*lo) with the reciprocal 1/Q held
as a double-float32 (hi, lo) pair; each product and the sum are separate
eager ops, so each is rounded once (no FMA contraction).
"""

import functools
from typing import Tuple

import numpy as np
import torch

from .resize import linear_weights


@functools.lru_cache(maxsize=None)
def _resize_bilinear_f64(key: Tuple, size: int) -> np.ndarray:
    m = np.array(key, dtype=np.float64).reshape(8, 8)
    wh = linear_weights(8, size)
    return np.einsum("ij,jk,lk->il", wh, m, wh)


def quantization_matrix(base8: np.ndarray, size: int, quality: int) -> np.ndarray:
    """Quality-scaled, resized int32 quantization matrix (reference parity)."""
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    scaled = np.floor((scale * base8.astype(np.float64) + 50.0) / 100.0)
    resized = _resize_bilinear_f64(tuple(scaled.ravel()), size)
    return np.clip(resized, 1.0, None).astype(np.int32)


def reciprocal_table(qmatrix: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """1/Q as a double-float32 (hi, lo) pair, precomputed host-side in f64."""
    inv = 1.0 / qmatrix.astype(np.float64)
    hi = inv.astype(np.float32)
    lo = (inv - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def quantize(coeffs: torch.Tensor, inv_hi: torch.Tensor,
             inv_lo: torch.Tensor) -> torch.Tensor:
    """round(coeffs / Q) -> int32; torch.round is round-half-to-even, as
    jnp.round and np.round (src/jpeg/jpeg.py:501) are."""
    return torch.round(coeffs * inv_hi + coeffs * inv_lo).to(torch.int32)


def dequantize(levels: torch.Tensor, qmatrix: torch.Tensor) -> torch.Tensor:
    """levels * Q -> float32 (src/jpeg/jpeg.py:524)."""
    return (levels.to(torch.int32) * qmatrix).to(torch.float32)
