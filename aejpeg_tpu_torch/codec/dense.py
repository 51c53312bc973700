"""Shared geometry for the dense batched pipeline.

The round-2 encoder/decoder redesign replaces per-bucket gathers with
*dense per-size level tables*: for every block size s in the config band,
the device DCTs/quantizes the whole padded plane as if uniformly tiled by
s, emitting one zigzag-int16 row per grid cell.  Host assembly (C++,
native/entropy.cpp aej_layer_payload) then reads exactly the rows the
quadtree plan selects — no gather indices ever cross the host link, and
stage B no longer depends on the plans at all, so host planning overlaps
device compute.  Boundary (partial) blocks come from a small static
"slow" bucket (reflect-padded, one row per possible partial block).

This module holds the static geometry both directions share: layer
grouping by downsampled shape, per-layer block-size bands, plane padding,
and the boundary-block enumeration whose rank order the C++ side mirrors
(entropy.cpp boundary_rank).
"""

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np

from ..utils.mathutils import root_size_for


def size_band(lh: int, lw: int, mn: int, mx: int) -> Tuple[int, ...]:
    """Every block size a quadtree leaf of an (lh, lw) layer can take under
    the split predicate (src/jpeg/quadtree.py:118): powers of two from
    min(mn, root) up to mx, capped at the root when the whole layer fits in
    one node."""
    root = root_size_for(lh, lw)
    hi = min(mx, root)
    lo = min(mn, root)
    k_lo = lo.bit_length() - 1
    k_hi = hi.bit_length() - 1
    return tuple(1 << k for k in range(k_lo, k_hi + 1))


@functools.lru_cache(maxsize=None)
def boundary_positions(lh: int, lw: int, s: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Origins (ys, xs) of every possible partial (boundary) s-block of an
    (lh, lw) layer, in the rank order entropy.cpp boundary_rank computes:
    the partial right column top-to-bottom (iff lw % s), then the partial
    bottom row left-to-right including the corner (iff lh % s)."""
    ghf, gwf = lh // s, lw // s
    gwc = -(-lw // s)
    ys, xs = [], []
    if lw % s:
        ys.extend(gy * s for gy in range(ghf))
        xs.extend([gwf * s] * ghf)
    if lh % s:
        ys.extend([ghf * s] * gwc)
        xs.extend(gx * s for gx in range(gwc))
    return (np.asarray(ys, np.int32), np.asarray(xs, np.int32))


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """One set of layers sharing a downsampled shape (e.g. the two chroma
    layers under 4:2:0)."""
    shape: Tuple[int, int]          # (lh, lw)
    layers: Tuple[int, ...]         # global layer indices, in layer order
    ph: int                         # padded plane height (multiple of max s)
    pw: int                         # padded plane width
    sizes: Tuple[int, ...]          # dense table sizes, ascending

    @property
    def n_l(self) -> int:
        return len(self.layers)

    def n_boundary(self, s: int) -> int:
        lh, lw = self.shape
        return len(boundary_positions(lh, lw, s)[0])


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Full static geometry for one (layer_shapes, block range) combo."""
    groups: Tuple[GroupSpec, ...]
    # global layer index -> (group index, position within group)
    layer_pos: Tuple[Tuple[int, int], ...]


@functools.lru_cache(maxsize=None)
def batch_spec(layer_shapes: Tuple[Tuple[int, int], ...], mn: int, mx: int
               ) -> BatchSpec:
    order: list = []
    by_shape: Dict[Tuple[int, int], list] = {}
    for li, sh in enumerate(layer_shapes):
        if sh not in by_shape:
            by_shape[sh] = []
            order.append(sh)
        by_shape[sh].append(li)
    groups = []
    layer_pos: Dict[int, Tuple[int, int]] = {}
    for gi, sh in enumerate(order):
        lh, lw = sh
        sizes = size_band(lh, lw, mn, mx)
        hi = max(sizes)
        ph = -(-lh // hi) * hi
        pw = -(-lw // hi) * hi
        layers = tuple(by_shape[sh])
        for j, li in enumerate(layers):
            layer_pos[li] = (gi, j)
        groups.append(GroupSpec(shape=sh, layers=layers, ph=ph, pw=pw,
                                sizes=sizes))
    return BatchSpec(groups=tuple(groups),
                     layer_pos=tuple(layer_pos[li]
                                     for li in range(len(layer_shapes))))
