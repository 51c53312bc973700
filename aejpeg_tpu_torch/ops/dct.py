"""DCT-II / DCT-III as separable fp32 matmuls.

Counterpart of the JAX package's ops/dct.py.  The orthonormal DCT matrix
matches OpenCV's definition:
    D[k, n] = a_k * cos(pi * (2n + 1) * k / (2N)),
    a_0 = sqrt(1/N), a_k = sqrt(2/N),
computed in float64 on the host and cast once.  The products are library
matmuls at full fp32 (TF32 is off, see the package __init__), as the JAX
package leaves them to XLA at precision="highest".  Their summation order
is the backend's, so the port matches JAX to a tolerance, not bitwise.

Every forward DCT, per-block (the Codec's gathered blocks, stage B's
boundary table) and dense (stage B's planes), runs as the same two 2-D
products `(M, s) @ (s, s)`, the block rows laid out contiguously, so that
each coefficient is one dot product of the same length over the same
operands whatever M is.  The batched form `D @ X` that a per-block call
would otherwise reach takes a naive loop for 4x4 blocks on the CPU and
BLAS for the dense planes, and the two differ in the last bit.
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


def _rows(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """x (..., s) contracted with d over the last axis (x @ d^T), as ONE
    contiguous (M, s) @ (s, s) product."""
    s = x.shape[-1]
    return torch.mm(x.reshape(-1, s), d.T).reshape(x.shape)


def dct2(blocks: torch.Tensor) -> torch.Tensor:
    """Forward 2-D DCT-II over a batch: (..., s, s) -> (..., s, s), D X D^T
    (the block's rows contracted first, as in the JAX package)."""
    d = _dct_tensor(blocks.shape[-1], blocks.device)
    return _rows(_rows(blocks.mT, d).mT, d)


def plane_blocks(planes: torch.Tensor, size: int) -> torch.Tensor:
    """(P, ph, pw) -> (P, gh, gw, s, s) view of the size-aligned blocks."""
    p, ph, pw = planes.shape
    return planes.reshape(p, ph // size, size, pw // size, size).permute(
        0, 1, 3, 2, 4)


def idct2(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse 2-D DCT (DCT-III with orthonormal scaling)."""
    d = _dct_tensor(coeffs.shape[-1], coeffs.device)
    return torch.matmul(torch.matmul(d.T, coeffs), d)


def dct2_dense(planes: torch.Tensor, size: int) -> torch.Tensor:
    """Forward 2-D DCT of every size-aligned block of (P, ph, pw) planes:
    (P, ph, pw) -> (P, gh, s, gw, s) view, coefficients in block-raster
    position; dct2 of the blocks, bit for bit."""
    return dct2(plane_blocks(planes, size)).permute(0, 1, 3, 2, 4)


def idct2_dense(blocks6: torch.Tensor) -> torch.Tensor:
    """Inverse of dct2_dense on the (..., gh, s, gw, s) layout: contracts
    the per-block row axis (-3) and column axis (-1) with the DCT-III."""
    shape = blocks6.shape
    s, gw = shape[-1], shape[-2]
    d = _dct_tensor(s, blocks6.device)
    y = torch.matmul(d.T, blocks6.reshape(shape[:-2] + (gw * s,)))
    return torch.matmul(y.reshape(shape), d)
