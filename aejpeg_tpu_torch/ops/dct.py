"""DCT-II / DCT-III as two contractions each, summed as XLA sums them.

Counterpart of the JAX package's ops/dct.py.  The orthonormal DCT matrix
matches OpenCV's definition:
    D[k, n] = a_k * cos(pi * (2n + 1) * k / (2N)),
    a_0 = sqrt(1/N), a_k = sqrt(2/N),
computed in float64 on the host and cast once.

The reference's two einsums per direction compile on the CPU to two 2-D
dots (M, s) @ (s, s), M the number of block rows (all elements / s),
whose products XLA sums in an order that depends on M and s
(ops/xla_dot.py).  Each pass here is one of those dots: a dense periodic
band (period s, one block of s inputs per output) summed in that order,
with XLA's flush-to-zero, by `kernels.dct2d`: both passes in one launch on
the card (the CUDA kernel), two passes of the plain version on the CPU,
which give the same bits.  The intermediate between the passes is
float32, as XLA rounds it between its dots.  No matmul library takes part.

The passes read the blocks where they lie: the first contracts axis 1 of a
(P, H, W) tensor in windows of s rows, the second axis 2 in windows of s
columns, so dense planes (P, ph, pw) and gathered blocks (N, s, s) take the
same kernel without a copy.  A per-block call and a dense call give the
same bits whenever their dots have the same M (a bucket of N blocks of a
(P, ph, pw) stack: N * s == P * ph * pw / s).
"""

import functools
from typing import Optional

import numpy as np
import torch

from . import kernels
from .xla_dot import Band, make_band


@functools.lru_cache(maxsize=None)
def dct_matrix(size: int) -> np.ndarray:
    n = np.arange(size, dtype=np.float64)
    k = n[:, None]
    d = np.cos(np.pi * (2 * n[None, :] + 1) * k / (2 * size))
    d *= np.sqrt(2.0 / size)
    d[0, :] = np.sqrt(1.0 / size)
    return d.astype(np.float32)


@functools.lru_cache(maxsize=None)
def band(size: int, m: int, inverse: bool, device: torch.device) -> Band:
    """The periodic band of one DCT pass whose dot has m rows: weights
    D[out, in] forward (D X, X D^T), D^T inverse (D^T X, X D)."""
    d = dct_matrix(size)
    b = make_band(np.ascontiguousarray(d.T if inverse else d), m, device,
                  stride=size)
    if b.dense_lanes() is None:
        raise ValueError(f"DCT of size {size}: XLA's order at m={m} is not "
                         "one dense band")
    return b


def _passes(x: torch.Tensor, size: int, inverse: bool, m: Optional[int],
            **epilogue) -> torch.Tensor:
    """Both passes over a contiguous (P, H, W) float32 tensor whose axes 1
    and 2 are whole numbers of blocks; m: the dots' rows (default: all
    elements / size); the epilogue as kernels.dct2d takes it."""
    m = m or x.numel() // size
    return kernels.dct2d(x, band(size, m, inverse, x.device), **epilogue)


def _capacity_rows(n_blocks: int, size: int, capacity: Optional[int]):
    return (capacity or n_blocks) * size


def dct2(blocks: torch.Tensor, capacity: Optional[int] = None
         ) -> torch.Tensor:
    """Forward 2-D DCT-II over a batch: (..., s, s) -> (..., s, s), D X D^T
    (the block's rows contracted first, as in the JAX package).  capacity:
    the number of blocks of the reference's dot, where it pads the batch
    (the JAX `Codec`'s buckets)."""
    s = blocks.shape[-1]
    x = blocks.reshape(-1, s, s).contiguous()
    return _passes(x, s, False, _capacity_rows(x.shape[0], s, capacity)
                   ).reshape(blocks.shape)


def idct2(coeffs: torch.Tensor, capacity: Optional[int] = None
          ) -> torch.Tensor:
    """Inverse 2-D DCT (DCT-III with orthonormal scaling), D^T X D."""
    s = coeffs.shape[-1]
    x = coeffs.reshape(-1, s, s).contiguous()
    return _passes(x, s, True, _capacity_rows(x.shape[0], s, capacity)
                   ).reshape(coeffs.shape)


def plane_blocks(planes: torch.Tensor, size: int) -> torch.Tensor:
    """(P, ph, pw) -> (P, gh, gw, s, s) view of the size-aligned blocks."""
    p, ph, pw = planes.shape
    return planes.reshape(p, ph // size, size, pw // size, size).permute(
        0, 1, 3, 2, 4)


def dct2_dense(planes: torch.Tensor, size: int) -> torch.Tensor:
    """Forward 2-D DCT of every size-aligned block of (P, ph, pw) planes:
    (P, ph, pw) -> (P, gh, s, gw, s) view, coefficients in block-raster
    position; dct2 of the blocks, bit for bit."""
    p, ph, pw = planes.shape
    y = _passes(planes.contiguous(), size, False, None)
    return y.view(p, ph // size, size, pw // size, size)


def idct2_dense(blocks6: torch.Tensor) -> torch.Tensor:
    """Inverse of dct2_dense on the (..., gh, s, gw, s) layout: contracts
    the per-block row axis (-3) and column axis (-1) with the DCT-III."""
    shape = blocks6.shape
    gh, s, gw = shape[-4], shape[-3], shape[-2]
    x = blocks6.reshape(-1, gh * s, gw * s).contiguous()
    return _passes(x, s, True, None).view(shape)


def idct2_planes(planes: torch.Tensor, size: int, add=None,
                 affine=None) -> torch.Tensor:
    """idct2_dense of (P, ph, pw) coefficient planes (blocks in place) ->
    (P, ph, pw) reconstructions, with the decoder's epilogue as the
    reference's jit fuses it: `add` (P, ph, pw) added first (add + y),
    then affine=(rcp, mid, group): fma(y, rcp[l], mid[l]) for plane p of
    layer l = (p // group) % L (kernels.dct2d)."""
    return _passes(planes.contiguous(), size, True, None, add=add,
                   affine=affine)


def dct2_quantize(x: torch.Tensor, size: int, inv_hi: torch.Tensor,
                  inv_lo: torch.Tensor, group: int = 1, zigzag: bool = True,
                  dtype: torch.dtype = torch.int16,
                  capacity: Optional[int] = None) -> torch.Tensor:
    """Forward DCT and quantize in one: (P, H, W) planes (or (N, s, s)
    blocks) -> (P, gh * gw, s * s) levels of `dtype`, one row per block in
    raster order, each row in zigzag order if `zigzag`.  Plane p uses the
    reciprocal tables inv_hi/inv_lo[(p // group) % L] of (L, s, s), and
    each level is XLA's round(fma(y, hi, y * lo)) of its coefficient y
    (kernels.quantize_plain); on the card the DCT kernel quantizes as it
    writes, so no float32 coefficient is stored.  capacity as in dct2."""
    if x.dim() != 3:
        raise ValueError("dct2_quantize: expected (P, H, W) planes or "
                         "(N, s, s) blocks")
    x = x.contiguous()
    m = _capacity_rows(x.numel() // (size * size), size, capacity) \
        if capacity else None
    tables = tuple(t.reshape(-1, size, size).contiguous()
                   for t in (inv_hi, inv_lo))
    return _passes(x, size, False, m,
                   quant=tables + (group, zigzag, dtype))
