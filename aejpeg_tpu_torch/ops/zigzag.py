"""Zigzag coefficient ordering.

Index tables are generated on the host once per block size (reference
algorithm: src/jpeg/jpeg.py:726-766); stages B and D apply them on the
device as gathers (codec/tables.py moves them there).
"""

import functools

import numpy as np


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

