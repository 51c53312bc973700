"""Scalar helpers (host side, static / trace-free).

Parity: semantics of `largest_power_of_2` match the reference rule
(src/jpeg/utils.py:24-41): n<=2 -> n, else 2**floor(log2(n-1)), i.e. the
largest power of two strictly below n (512 -> 256, 513 -> 512).  The codec
uses `largest_power_of_2(x) * 2` as the quadtree root size, which is the
smallest power of two >= x for x > 2 (512 -> 512, 513 -> 1024).
"""

import math
from typing import List, Tuple


def largest_power_of_2(n: int) -> int:
    """Largest power of two <= n for powers of two, else < n (reference rule)."""
    if n <= 0:
        raise ValueError("n must be positive.")
    if n <= 2:
        return n
    return 2 ** int(math.floor(math.log2(n - 1)))


def root_size_for(h: int, w: int) -> int:
    """Quadtree root size: smallest pow2 covering max(h, w) per the reference
    growth rule (src/jpeg/quadtree.py:89-90)."""
    return largest_power_of_2(max(h, w)) * 2


def block_sizes_in_range(block_size_range: Tuple[int, int]) -> List[int]:
    """All power-of-two block sizes within [min, max] inclusive
    (src/jpeg/jpeg.py:219)."""
    lo, hi = block_size_range
    return [2 ** i for i in range(int(math.log2(lo)), int(math.log2(hi)) + 1)]


def quality_factor(block_size: int, block_size_range: Tuple[int, int],
                   quality_range: Tuple[int, int]) -> int:
    """Per-block-size quality, log-interpolated: smallest block -> max quality
    (src/jpeg/jpeg.py:688-705)."""
    min_bs, max_bs = block_size_range
    min_q, max_q = quality_range
    if min_bs == max_bs:
        return int((min_q + max_q) / 2)
    return int(min_q + (max_q - min_q) *
               (1 - math.log(block_size / min_bs) / math.log(max_bs / min_bs)))
