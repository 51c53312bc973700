"""Edge-aware quadtree as data-parallel mask pyramids + Morton-order preorder.

The reference builds a pointer tree with an explicit stack and per-region
`np.any` scans (src/jpeg/quadtree.py:93-134), then serializes it by preorder
DFS emitting 2-bit states — '00' leaf, '01' split, '10' absent-child
(src/jpeg/quadtree.py:136-165).  This module produces bit-identical state
streams and identical preorder leaf lists **without any tree**, via two
observations:

1. "Region has an edge" for every power-of-two block is a max-pool pyramid
   over the edge map — O(N) vectorized work instead of O(N log N) rescans.
2. Preorder DFS with TL,TR,BL,BR child order visits nodes exactly in
   (Morton-code-of-origin, size-descending) order, so the state stream is a
   single vectorized sort over per-level visited masks.

Split predicate parity (src/jpeg/quadtree.py:118):
    split(size) = size > max_size OR (size > min_size AND any(region == 1.0))
Nodes whose origin falls outside the image (x >= W or y >= H) are "absent"
and serialize as state 2 (src/jpeg/quadtree.py:108-110,153-155).
Root size rule: smallest power of two covering max(H, W)
(src/jpeg/quadtree.py:89-90, src/jpeg/utils.py:24-41).
"""

import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np

from ..utils.mathutils import root_size_for

STATE_LEAF = 0
STATE_SPLIT = 1
STATE_ABSENT = 2


@dataclasses.dataclass
class QuadPlan:
    """Host-side encode plan for one layer."""
    root_size: int
    height: int
    width: int
    states: np.ndarray        # (n_nodes,) uint8 in preorder (may be None
                              # when states_packed is set)
    leaf_sizes: np.ndarray    # (n_leaves,) int32 in preorder
    leaf_y: np.ndarray        # (n_leaves,) int32
    leaf_x: np.ndarray        # (n_leaves,) int32
    states_packed: bytes = None   # container-format 2-bit stream (optional)
    bits_len: int = 0             # valid with states_packed

    def packed(self):
        """(states_bytes, bits_len) in container format."""
        if self.states_packed is not None:
            return self.states_packed, self.bits_len
        return pack_states(self.states)


def _interleave_bits(i: np.ndarray, j: np.ndarray, nbits: int) -> np.ndarray:
    """Morton code with i (row) in the high bit of each pair: the child order
    TL,TR,BL,BR ranks x as bit0 and y as bit1."""
    code = np.zeros(i.shape, dtype=np.int64)
    i = i.astype(np.int64)
    j = j.astype(np.int64)
    for b in range(nbits):
        code |= ((j >> b) & 1) << (2 * b)
        code |= ((i >> b) & 1) << (2 * b + 1)
    return code


def edge_pyramid(edge: np.ndarray, root_size: int) -> List[np.ndarray]:
    """has_edge masks per level: pyr[k] is (R/2^k, R/2^k) bool, True iff the
    2^k-sized block at that grid cell contains an edge pixel (== 1.0,
    matching src/jpeg/quadtree.py:27-38)."""
    h, w = edge.shape
    level0 = np.zeros((root_size, root_size), dtype=bool)
    level0[:h, :w] = edge == 1.0
    pyr = [level0]
    cur = level0
    while cur.shape[0] > 1:
        g = cur.shape[0] // 2
        cur = cur.reshape(g, 2, g, 2).any(axis=(1, 3))
        pyr.append(cur)
    return pyr


def build_plan(edge: np.ndarray, max_size: int, min_size: int) -> QuadPlan:
    """Compute the full encode plan for one layer from its edge map."""
    h, w = edge.shape
    root = root_size_for(h, w)
    pyr = edge_pyramid(edge, root)
    return plan_from_levels({k: p for k, p in enumerate(pyr)}, h, w,
                            max_size, min_size)


def plan_from_levels(levels, h: int, w: int, max_size: int,
                     min_size: int) -> QuadPlan:
    """Plan from precomputed has-edge pyramid levels.

    `levels[k]` is the (>= R/2^k, >= R/2^k) bool mask for node size 2^k;
    only levels with min_size < 2^k <= max_size are consulted (the split
    predicate ignores edges outside that band), so batched pipelines can
    compute/transfer just those — 1/64th of the pixels for min_size 4."""
    root = root_size_for(h, w)
    lmax = root.bit_length() - 1            # root level: size = 2**lmax
    kmin = min(min_size.bit_length() - 1, lmax)

    # Per-level masks, from root down.
    visited: Dict[int, np.ndarray] = {}
    split: Dict[int, np.ndarray] = {}
    absent: Dict[int, np.ndarray] = {}
    v = np.ones((1, 1), dtype=bool)
    for k in range(lmax, kmin - 1, -1):
        s = 1 << k
        g = root >> k
        jj = np.arange(g) * s
        exists = (jj[:, None] < h) & (jj[None, :] < w)  # (i: y, j: x)
        absent_k = v & ~exists
        if k > kmin:
            if s > max_size:
                do_split = v & exists
            elif s > min_size:
                do_split = v & exists & np.asarray(levels[k])[:g, :g]
            else:
                do_split = np.zeros((g, g), dtype=bool)
        else:
            do_split = np.zeros((g, g), dtype=bool)
        visited[k] = v
        split[k] = do_split
        absent[k] = absent_k
        if k > kmin:
            v = np.repeat(np.repeat(do_split, 2, axis=0), 2, axis=1)

    # Flatten all visited nodes -> (morton, depth, state, y, x, size).
    mortons, keys2, states, ys, xs, sizes = [], [], [], [], [], []
    for k in range(lmax, kmin - 1, -1):
        vi, vj = np.nonzero(visited[k])
        if vi.size == 0:
            continue
        s = 1 << k
        m = _interleave_bits(vi, vj, lmax - k) << np.int64(2 * k)
        st = np.zeros(vi.shape, dtype=np.uint8)
        st[split[k][vi, vj]] = STATE_SPLIT
        st[absent[k][vi, vj]] = STATE_ABSENT
        mortons.append(m)
        keys2.append(np.full(vi.shape, lmax - k, dtype=np.int64))
        states.append(st)
        ys.append((vi * s).astype(np.int32))
        xs.append((vj * s).astype(np.int32))
        sizes.append(np.full(vi.shape, s, dtype=np.int32))

    morton = np.concatenate(mortons)
    depth = np.concatenate(keys2)
    state = np.concatenate(states)
    y = np.concatenate(ys)
    x = np.concatenate(xs)
    size = np.concatenate(sizes)

    # Preorder == sort by (morton, depth): a node precedes its descendants
    # (same morton prefix, smaller depth) and all nodes in later subtrees.
    # depth < 64 packs into the low 6 bits -> one single-key argsort
    # (measurably faster than lexsort at ~30k nodes/layer).
    order = np.argsort((morton << np.int64(6)) | depth)
    state = state[order]

    leaf_mask = state == STATE_LEAF
    ord_leaf = order[leaf_mask]
    return QuadPlan(
        root_size=root, height=h, width=w, states=state,
        leaf_sizes=size[ord_leaf], leaf_y=y[ord_leaf], leaf_x=x[ord_leaf])


@functools.lru_cache(maxsize=256)
def uniform_plan(h: int, w: int, size: int) -> QuadPlan:
    """Plan for min_block == max_block == size: the split predicate can never
    consult the edge map (src/jpeg/quadtree.py:118 with size bounds equal),
    so the plan depends only on the shape — cache it and skip edge detection
    entirely."""
    return build_plan(np.zeros((h, w), np.float32), size, size)


# ------------------------------------------------------------ serialization

def pack_states(states: np.ndarray) -> Tuple[bytes, int]:
    """2-bit states -> zero-padded bytes + bit length
    (format: src/jpeg/jpeg.py:563-577)."""
    bits = np.empty(states.size * 2, dtype=np.uint8)
    bits[0::2] = (states >> 1) & 1
    bits[1::2] = states & 1
    return np.packbits(bits).tobytes(), int(bits.size)

