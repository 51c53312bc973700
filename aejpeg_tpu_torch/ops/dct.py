"""DCT-II / DCT-III as separable fp32 matmuls.

Counterpart of the JAX package's ops/dct.py.  The orthonormal DCT matrix
matches OpenCV's definition:
    D[k, n] = a_k * cos(pi * (2n + 1) * k / (2N)),
    a_0 = sqrt(1/N), a_k = sqrt(2/N),
computed in float64 on the host and cast once.  The products are library
matmuls at full fp32 (TF32 is off, see the package __init__), as the JAX
package leaves them to XLA at precision="highest".  Their summation order
is the backend's, so the port matches JAX to a tolerance, not bitwise.
"""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def dct_matrix(size: int) -> np.ndarray:
    n = np.arange(size, dtype=np.float64)
    k = n[:, None]
    d = np.cos(np.pi * (2 * n[None, :] + 1) * k / (2 * size))
    d *= np.sqrt(2.0 / size)
    d[0, :] = np.sqrt(1.0 / size)
    return d.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct_tensor(size: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(dct_matrix(size), device=device)


def dct2(blocks: torch.Tensor) -> torch.Tensor:
    """Forward 2-D DCT-II over a batch: (..., s, s) -> (..., s, s)."""
    d = _dct_tensor(blocks.shape[-1], blocks.device)
    return torch.matmul(torch.matmul(d, blocks), d.T)


def idct2(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse 2-D DCT (DCT-III with orthonormal scaling)."""
    d = _dct_tensor(coeffs.shape[-1], coeffs.device)
    return torch.matmul(torch.matmul(d.T, coeffs), d)


def dct2_dense(planes: torch.Tensor, size: int) -> torch.Tensor:
    """Forward 2-D DCT of every size-aligned block of (P, ph, pw) planes:
    (P, ph, pw) -> (P, gh, s, gw, s), coefficients in block-raster
    position."""
    p, ph, pw = planes.shape
    gh, gw = ph // size, pw // size
    d = _dct_tensor(size, planes.device)
    y = torch.matmul(d, planes.reshape(p * gh, size, pw))   # rows of blocks
    y = y.reshape(p, gh, size, gw, size)
    return torch.matmul(y, d.T)                             # columns


def idct2_dense(blocks6: torch.Tensor) -> torch.Tensor:
    """Inverse of dct2_dense on the (..., gh, s, gw, s) layout: contracts
    the per-block row axis (-3) and column axis (-1) with the DCT-III."""
    shape = blocks6.shape
    s, gw = shape[-1], shape[-2]
    d = _dct_tensor(s, blocks6.device)
    y = torch.matmul(d.T, blocks6.reshape(shape[:-2] + (gw * s,)))
    return torch.matmul(y.reshape(shape), d)
