"""Zigzag coefficient ordering.

Index tables are generated on the host once per block size (reference
algorithm: src/jpeg/jpeg.py:726-766); stages B and D apply them on the
device as gathers (codec/tables.py moves them there), and the per-image
Codec through zigzag_gather / zigzag_scatter.
"""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def zigzag_indices(size: int) -> np.ndarray:
    """Indices that flatten a size x size block in zigzag order.

    Walks the standard JPEG zigzag: up-right diagonals from (0,0), bouncing
    off the edges (matches src/jpeg/jpeg.py:726-766 bit-for-bit).
    """
    if not isinstance(size, int) or size < 0:
        raise ValueError("Block size must be a non-negative integer")
    out = np.empty(size * size, dtype=np.int32)
    row = col = 0
    for i in range(size * size):
        out[i] = row * size + col
        if (row + col) % 2 == 0:  # moving up-right
            if col == size - 1:
                row += 1
            elif row == 0:
                col += 1
            else:
                row -= 1
                col += 1
        else:  # moving down-left
            if row == size - 1:
                col += 1
            elif col == 0:
                row += 1
            else:
                row += 1
                col -= 1
    return out


@functools.lru_cache(maxsize=None)
def inverse_zigzag_indices(size: int) -> np.ndarray:
    """Permutation that scatters a zigzag vector back to raster order."""
    zz = zigzag_indices(size)
    inv = np.empty_like(zz)
    inv[zz] = np.arange(size * size, dtype=np.int32)
    return inv


@functools.lru_cache(maxsize=None)
def _index_tensor(size: int, inverse: bool, device: torch.device
                  ) -> torch.Tensor:
    idx = inverse_zigzag_indices(size) if inverse else zigzag_indices(size)
    return torch.as_tensor(idx.astype(np.int64), device=device)


def zigzag_gather(blocks: torch.Tensor) -> torch.Tensor:
    """(N, s, s) -> (N, s*s) in zigzag order."""
    n, s, _ = blocks.shape
    return blocks.reshape(n, s * s)[:, _index_tensor(s, False, blocks.device)]


def zigzag_scatter(vectors: torch.Tensor, size: int) -> torch.Tensor:
    """(N, s*s) zigzag vectors -> (N, s, s) raster blocks."""
    idx = _index_tensor(size, True, vectors.device)
    return vectors[:, idx].reshape(vectors.shape[0], size, size)
