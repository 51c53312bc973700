"""The order in which XLA's CPU backend sums a float32 dot, and the band
tables that let one kernel sum a contraction in that order.

The JAX reference's einsums (the dense resize's two, the DCT's two per
direction) compile on the CPU to 2-D dots (m, k) @ (k, n) whose B operand
is a constant.  XLA hands such a dot to YNNPACK, and the bits of each
result depend on the order in which its products are summed.  The port
reproduces that order (`xla_dot_order`) and describes each contraction as
a `Band`: for every output, the non-zero taps laid out as XLA sums them.
`ops/kernels.banded_resize` (CUDA kernel and plain version) sums a band;
`ops/kernels.dct_pass` sums a dense periodic one, the DCT's.

Read off jaxlib 0.9.0 on an x86-64 CPU with AVX-512 (avx512f/dq/bw/vl,
FMA): XLA's ynn_support.cc, YNNPACK's get_dot_kernel and the results of
jax.jit on dense random operands (`tools/xla_dot_order.py check M K N`
holds the rule to XLA at any shape).  Another XLA, or a CPU without
AVX-512, may sum in another order.
"""

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

# YNNPACK's float32 dot kernels on x86-64 (jaxlib 0.9.0), in the order its
# get_dot_kernel tries them: (block_m, block_n, block_k, cost factor).  A
# kernel's cost is ceil(m/bm) * ceil(n/bn) * ceil(k/bk) * factor in float32,
# and the first strictly cheapest kernel wins.  block_k is the kernel's
# tile_k: the dot keeps tile_k partial sums per output, one per k modulo
# tile_k, each a chain of FMAs from zero, and adds them as a tree at the
# end.  The schedule splits k into blocks of 32768 / block_n, each summed
# that way from zero, and adds the blocks in order; the k past the last
# multiple of tile_k come last, as a tree of single products.
_YNN_F32_KERNELS = (
    (1, 64, 1, 58), (2, 64, 1, 63), (3, 64, 1, 68), (4, 64, 1, 73),
    (5, 64, 1, 78), (2, 32, 1, 41), (3, 32, 1, 46), (4, 32, 1, 51),
    (5, 32, 1, 56), (5, 16, 1, 45), (1, 32, 2, 58), (2, 32, 2, 63),
    (3, 32, 2, 68), (4, 32, 2, 73), (5, 32, 2, 78), (4, 16, 2, 51),
    (4, 8, 2, 40), (8, 8, 2, 60), (1, 32, 4, 102), (2, 32, 4, 107),
    (3, 16, 4, 68), (4, 16, 4, 73), (5, 16, 4, 78), (2, 8, 4, 41),
    (4, 8, 4, 51), (6, 8, 4, 61), (4, 4, 4, 40), (8, 4, 4, 60),
    (12, 4, 4, 80), (1, 32, 1, 58), (2, 32, 1, 63), (1, 16, 1, 36),
    (2, 16, 1, 41), (3, 16, 1, 46), (4, 16, 1, 51), (5, 16, 1, 56),
    (6, 16, 1, 61), (8, 8, 1, 60), (1, 16, 2, 58), (2, 16, 2, 63),
    (3, 8, 2, 46), (4, 8, 2, 51), (5, 8, 2, 56), (6, 8, 2, 61),
    (4, 4, 2, 40), (5, 4, 2, 45), (6, 4, 2, 50), (8, 4, 2, 60),
    (1, 32, 1, 58), (2, 32, 1, 63), (2, 16, 1, 41), (3, 16, 1, 46),
    (4, 16, 1, 51), (4, 8, 1, 40), (6, 8, 1, 50), (8, 8, 1, 60),
    (1, 16, 2, 58), (2, 16, 2, 63), (3, 8, 2, 46), (4, 8, 2, 51),
    (5, 8, 2, 56), (6, 8, 2, 61), (4, 4, 2, 40), (5, 4, 2, 45),
    (6, 4, 2, 50), (8, 4, 2, 60), (1, 16, 1, 58), (2, 16, 1, 63),
    (3, 16, 1, 68), (2, 8, 1, 41), (3, 8, 1, 46), (4, 8, 1, 51),
    (4, 4, 1, 40), (6, 4, 1, 50), (8, 4, 1, 60), (1, 128, 1, 100))

# XLA keeps a dot whose m, n and k are all at most this for its own loop,
# which sums k in order (one chain).
_XLA_OWN_DOT_MAX = 7
# Up to this m, YNNPACK keeps B unpacked unless n is small: measured, see
# `xla_dot_plan`.
_SMALL_M = 50
_SMALL_M_MAX_N = 16
# At m <= 50 with one chain, the columns go in groups of this many, and each
# group's k-blocks hold 32768 // (its width) products (measured).
_SMALL_M_COLUMN_GROUP = 64
# At k 2-3 and n 3-8 the first PAIRED[n] columns of the rows below the last
# multiple of 8 sum as two partial sums, the rest as one chain (measured).
_PAIRED = {3: 2, 4: 4, 5: 4, 6: 4, 7: 6, 8: 8}


def _ynn_best(m: int, n: int, k: int, tile_k=None) -> Tuple[int, int]:
    """(tile_k, block_n) of YNNPACK's cheapest kernel, optionally among
    those of one tile_k."""
    f32 = np.float32
    best = None
    for bm, bn, bk, factor in _YNN_F32_KERNELS:
        if tile_k is not None and bk != tile_k:
            continue
        cost = f32(f32(-(-m // bm)) * f32(-(-n // bn))) * f32(-(-k // bk))
        cost = f32(cost * f32(factor))
        if best is None or cost < best[0]:
            best = (cost, bk, bn)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def xla_dot_plan(m: int, k: int, n: int) -> Tuple[int, int]:
    """(lanes, k_block) of XLA's CPU dot (m, k) @ (k, n) in float32, for the
    columns and rows where it is uniform (`xla_dot_order` gives the
    exceptions).
    - m, n, k all <= 7: XLA's own loop, one chain over k.
    - m > 50: YNNPACK's cheapest kernel (`_ynn_best`); checked at random
      shapes up to m 1000 and k 1500, and its k-blocks up to k 4200.  A k
      under 4 sums as one chain (but see `xla_dot_order` for n 3-8).
    - m <= 50 (measured, not derived): 4 lanes while n <= 16, except at
      the k where padding k to a multiple of 4 costs too much (k < 4;
      k = 5 once n > 4; k in 6, 9, 10, 13, 17 once n > 8), and for m <= 3
      with n <= 3; else one chain.  k-blocks of 8192, 4096 or 2048 for 4
      lanes as n is at most 4, 12 or 16; for one chain, see
      `xla_dot_order` (2048 here, the width of 16 columns).
    """
    if max(m, n, k) <= _XLA_OWN_DOT_MAX:
        return 1, k
    if m > _SMALL_M:
        lanes, bn = _ynn_best(m, n, k)
        if k < 4:
            lanes, bn = _ynn_best(m, n, k, 1)
        return lanes, 32768 // bn
    if (m <= 3 and n <= 3) or n > _SMALL_M_MAX_N or k < 4:
        return 1, 2048
    if (n > 4 and k == 5) or (n > 8 and k in (6, 9, 10, 13, 17)):
        return 1, 2048
    return 4, 32768 // (4 if n <= 4 else 8 if n <= 12 else 16)


class DotOrder(NamedTuple):
    """XLA's order for every output column of a dot: `columns[j]` is the
    (lanes, k_block) of column j in the rows below `row_split`;
    `tail_columns[j]` that of the rows from `row_split` on."""
    columns: Tuple[Tuple[int, int], ...]
    row_split: int
    tail_columns: Tuple[Tuple[int, int], ...]


@functools.lru_cache(maxsize=None)
def xla_dot_order(m: int, k: int, n: int) -> DotOrder:
    """The order of every result of XLA's CPU dot (m, k) @ (k, n): the
    uniform `xla_dot_plan`, with two measured exceptions.
    - k 2-3, n 3-8, for m >= 32 and for m in 16-31 with m % 8 < 4: in the
      rows below the last multiple of 8, the first _PAIRED[n] columns sum
      as two partial sums (products rounded, then added); every other
      result is one chain.  (Checked at m 8-63, 100, 128, 200, 1000-1007.)
    - m <= 50 with one chain over k and n > 16: the columns go in groups
      of 64, and each group's k-blocks hold 32768 // (its width)
      products.  (Checked at m 20-38 with k 800-1100 and n 17-200, and at
      m 10 with n up to 64; at m 10 with n 100 XLA sums otherwise: not
      modelled.)"""
    lanes, k_block = xla_dot_plan(m, k, n)
    uniform = ((lanes, k_block),) * n
    if (k in (2, 3) and 3 <= n <= 8
            and (m >= 32 or (m >= 16 and m % 8 < 4))):
        paired = _PAIRED[n]
        cols = tuple((2, k_block) if j < paired else (1, k_block)
                     for j in range(n))
        return DotOrder(cols, m // 8 * 8, ((1, k_block),) * n)
    if (m <= _SMALL_M and lanes == 1 and n > _SMALL_M_MAX_N
            and max(m, n, k) > _XLA_OWN_DOT_MAX):
        g = _SMALL_M_COLUMN_GROUP
        cols = tuple((1, 32768 // (min(n, j // g * g + g) - j // g * g))
                     for j in range(n))
        return DotOrder(cols, m, cols)
    return DotOrder(uniform, m, uniform)


class Band(NamedTuple):
    """A contraction along one axis, as XLA sums it: for every output o, the
    non-zero taps of its dot row laid out per k-block as `lanes` chains of
    up to `steps` taps, then up to `lanes` tail taps (the k past the last
    multiple of the lanes; ops/kernels.banded_resize_plain gives the order).

    The outputs repeat with `period`: output o reads table row o % period,
    at input offset (o // period) * stride (stride 0: one period spans the
    axis, as in a resize; the DCT's period and stride are its block size).
    Dot rows from `row_split` on read table 1 instead of table 0.

    The tables are slot-major, so that neighbouring outputs of one slot
    lie side by side:
    idx, weight: (2, slots, period) int32 / float32, the tap's input index
        within the period's window (-1: no tap) and its weight.
    lanes_of: (2, period) int32, the partial sums of each output's tree.
    k_block: (2, period) int32, the k-block length of each output's dot.
    complete: (2, period) uint8, 1 where every partial sum of every
        k-block of XLA's dot holds a tap (else a zero result is +0).
    trail: (2, blocks * lanes, period) int32, the first k of each partial
        sum past its last tap (-1: none), for the sign of a zero result.
    src: the dot's k (the contracted length of one period's window).
    small_weight: 1 if a weight lies under 2**-10 in magnitude (then even
        inputs of 2**-60 and more can make results under 2**-126)."""
    idx: torch.Tensor
    weight: torch.Tensor
    lanes_of: torch.Tensor
    k_block: torch.Tensor
    complete: torch.Tensor
    trail: torch.Tensor
    blocks: int
    lanes: int
    steps: int
    period: int
    stride: int
    row_split: int
    src: int
    small_weight: int

    @property
    def slots(self) -> int:
        return self.blocks * (self.lanes * self.steps + self.lanes)

    def dense_lanes(self):
        """The lane count when this is a dense band in canonical order
        (every k a tap, table 1 equal to table 0, slot c * steps + t
        holding k = t * lanes + c, no tail), else None: the DCT's
        kernel reads such a band's weights only."""
        lanes = self.lanes
        if self.blocks != 1 or self.src % lanes or self.steps * lanes != \
                self.src:
            return None
        idx = self.idx.cpu().numpy()
        want = (np.arange(self.steps)[None, :] * lanes
                + np.arange(lanes)[:, None]).reshape(-1)
        ok = (idx[:, :lanes * self.steps] == want[:, None]).all() and \
            (idx[:, lanes * self.steps:] < 0).all() and \
            (self.lanes_of.cpu().numpy() == lanes).all()
        return lanes if ok else None


def _order_tables(w: np.ndarray, orders: Sequence[Tuple[int, int]]):
    """Host tables of one table of a band: the (period, src) float32
    weights w summed with per-output (lanes, k_block) orders."""
    period, src = w.shape
    per_out = []
    for o in range(period):
        lanes, k_block = orders[o]
        blocks = {}
        for lo in range(0, src, k_block):
            hi = min(src, lo + k_block)
            main_end = lo + (hi - lo) // lanes * lanes
            chains, tail = [[] for _ in range(lanes)], [None] * lanes
            for k in np.nonzero(w[o, lo:hi])[0] + lo:
                if k < main_end:
                    chains[(k - lo) % lanes].append(int(k))
                else:
                    tail[k - main_end] = int(k)
            blocks[lo] = (chains, tail, main_end, hi)
        per_out.append(blocks)
    return per_out


def _band_host(w: np.ndarray, tables: Sequence[Sequence[Tuple[int, int]]]):
    """Host arrays of `Band` for (period, src) weights w, one table per
    sequence of per-output (lanes, k_block) orders."""
    period, src = w.shape
    laid = [_order_tables(w, orders) for orders in tables]
    lanes = max(l for orders in tables for l, _ in orders)
    keep = [[[lo for lo, (ch, tl, _, _) in out.items()
              if any(ch) or any(t is not None for t in tl)] or [0]
             for out in per_out] for per_out in laid]
    n_blocks = max(len(b) for t in keep for b in t)
    steps = max([len(c) for per_out in laid for out in per_out
                 for ch, _, _, _ in out.values() for c in ch] + [1])
    width = lanes * steps + lanes
    nt = 2
    idx = np.full((nt, period, n_blocks * width), -1, np.int32)
    lanes_of = np.ones((nt, period), np.int32)
    k_block = np.ones((nt, period), np.int32)
    complete = np.zeros((nt, period), bool)
    trail = np.full((nt, period, n_blocks * lanes), -1, np.int32)
    for t in range(nt):
        ti = min(t, len(tables) - 1)
        for o in range(period):
            lanes_of[t, o], k_block[t, o] = tables[ti][o]
            out = laid[ti][o]
            ok = True
            for j, lo in enumerate(keep[ti][o]):
                chains, tail, main_end, hi = out[lo]
                base = j * width
                for c, chain in enumerate(chains):
                    idx[t, o, base + c * steps:
                        base + c * steps + len(chain)] = chain
                    if chain and chain[-1] + lanes_of[t, o] < main_end:
                        trail[t, o, j * lanes + c] = \
                            chain[-1] + lanes_of[t, o]
                for c, k in enumerate(tail):
                    if k is not None:
                        idx[t, o, base + lanes * steps + c] = k
            for chains, tail, main_end, hi in out.values():
                ok &= all(chains) and all(
                    tail[c] is not None for c in range(hi - main_end))
            complete[t, o] = ok
    weight = np.where(idx >= 0, np.take_along_axis(
        np.broadcast_to(w, (nt, period, src)),
        np.maximum(idx, 0), axis=2), 0.0).astype(np.float32)
    return idx, weight, lanes_of, k_block, complete, trail, n_blocks, steps


def make_band(w: np.ndarray, m: int, device: torch.device,
              stride: int = 0) -> Band:
    """The band of a contraction with (period, src) float32 weights whose
    dot is (m, src) @ (src, period), on `device`.  stride 0: one period
    spans the axis (a resize); else the axis holds periods of `period`
    outputs, each reading `src` inputs from offset (o // period) * stride
    (the DCT: a dot over the rows of the blocks)."""
    period, src = w.shape
    order = xla_dot_order(m, src, period)
    cols = list(order.columns)
    tail = list(order.tail_columns)
    host = _band_host(np.ascontiguousarray(w, np.float32),
                      [cols] if order.row_split >= m else [cols, tail])
    idx, weight, lanes_of, k_block, complete, trail, n_blocks, steps = host
    lanes = max(l for l, _ in cols + tail)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return Band(dev(idx.transpose(0, 2, 1)), dev(weight.transpose(0, 2, 1)),
                dev(lanes_of), dev(k_block), dev(complete.astype(np.uint8)),
                dev(trail.transpose(0, 2, 1)), n_blocks, lanes, steps,
                period, stride, order.row_split, src,
                int(bool((np.abs(w[w != 0]) < 2.0 ** -10).any())))
