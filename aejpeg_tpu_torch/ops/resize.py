"""Separable resizes: OpenCV INTER_AREA down / INTER_LINEAR up.

Counterpart of the JAX package's ops/resize.py.  The exact OpenCV row and
column weights are precomputed on the host in float64.  Exact integer-ratio
downscales (4:2:0 chroma: 2x per axis; 4:1:1: 4x on width) take a grouped
fast path with the same f32 weights (powers of two, so every product is
exact) and a fixed accumulation order: sequential on W, pairwise on H.

Every other resize is the reference's pair of float32 einsums, H then W.
XLA compiles each into a 2-D dot, (b*w, h) @ Wh^T and then (b*dh, w) @
Ww^T, and its CPU backend hands the dot to YNNPACK, whose kernel sums in
an order that depends on the shape (`xla_dot_plan`).  The port computes
the same sums over the few non-zero taps of each output (the band):
FMAs that round once, in XLA's order, with its flush-to-zero.  The same
ops run on both devices (`ops/kernels.banded_resize`), so a resize gives
the same bits on the card as on the CPU.  No matmul library takes part.
"""

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import kernels


@functools.lru_cache(maxsize=None)
def linear_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear weight matrix matching cv.resize INTER_LINEAR for
    float images: src_x = (dst_x + 0.5) * scale - 0.5 with edge clamping."""
    w = np.zeros((dst, src), dtype=np.float64)
    if src == 1:
        w[:, 0] = 1.0
        return w
    scale = src / dst
    for dx in range(dst):
        fx = (dx + 0.5) * scale - 0.5
        sx = int(np.floor(fx))
        fx -= sx
        if sx < 0:
            sx, fx = 0, 0.0
        if sx >= src - 1:
            sx, fx = src - 2, 1.0
        w[dx, sx] += 1.0 - fx
        w[dx, sx + 1] += fx
    return w


@functools.lru_cache(maxsize=None)
def area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) averaging weights matching cv.resize INTER_AREA for
    true downscale (scale >= 1): each dst pixel averages the src cells
    overlapping [dx*scale, (dx+1)*scale) with fractional boundary weights."""
    if dst > src:
        raise ValueError("area_weights is for downscaling only")
    w = np.zeros((dst, src), dtype=np.float64)
    scale = src / dst
    inv = 1.0 / scale
    for dx in range(dst):
        lo = dx * scale
        hi = lo + scale
        cell = int(np.floor(lo))
        x = lo
        while x < hi - 1e-12 and cell < src:
            right = min(cell + 1.0, hi)
            w[dx, cell] += (right - max(x, cell)) * inv
            x = right
            cell += 1
    return w


# ------------------------------------------------ integer-ratio fast path


def _down_taps(src: int, dst: int, kind: str):
    """Per-group tap weights [w_0..w_{r-1}] for an exact integer-ratio
    downscale whose rows each cover exactly [i*r, (i+1)*r), else None."""
    if dst == 0 or src % dst or src == dst:
        return None
    r = src // dst
    w = (area_weights if kind == "area" else linear_weights)(src, dst)
    taps = w[0, :r].copy()
    for i in range(dst):
        row = w[i]
        if np.any(row[: i * r]) or np.any(row[(i + 1) * r:]):
            return None
        if not np.array_equal(row[i * r: (i + 1) * r], taps):
            return None
    return [np.float32(t) for t in taps]


def _down_axis(img: torch.Tensor, axis: int, dst: int, taps) -> torch.Tensor:
    """Grouped r-tap downscale along axis (-1 or -2): a reshape that splits
    the axis plus r multiply-adds, each rounded once."""
    r = len(taps)
    if axis == -1:
        xg = img.reshape(img.shape[:-1] + (dst, r))
        terms = [xg[..., t] * float(taps[t]) for t in range(r)]
        acc = terms[0]                  # sequential, ascending source
        for t in range(1, r):
            acc = acc + terms[t]
        return acc
    xg = img.reshape(img.shape[:-2] + (dst, r, img.shape[-1]))
    terms = [xg[..., t, :] * float(taps[t]) for t in range(r)]
    while len(terms) > 1:               # pairwise (binary tree)
        terms = [terms[i] + terms[i + 1] if i + 1 < len(terms)
                 else terms[i] for i in range(0, len(terms), 2)]
    return terms[0]


@functools.lru_cache(maxsize=None)
def _axis_fast(src: int, dst: int, kind: str, axis: int):
    """Tuple of per-group taps for an exact-integer downscale axis, else
    None.  Same gate as the JAX package: r=2 on either axis, r=4 on the
    lane axis at real image widths (4:1:1); everything else, upscales
    included, keeps the dense-matmul path."""
    if dst >= src:
        return None
    taps = _down_taps(src, dst, kind)
    if taps is None:
        return None
    r = len(taps)
    ok = r == 2 or (axis == -1 and r == 4 and dst >= 64)
    return tuple(taps) if ok else None


# ------------------------------------------------ XLA's dot, as a band
#
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
    """(lanes, k_block) of XLA's CPU dot (m, k) @ (k, n) in float32.

    Read off jaxlib 0.9.0 on an x86-64 CPU with AVX-512 (avx512f/dq/bw/vl,
    FMA): XLA's ynn_support.cc, YNNPACK's get_dot_kernel and the results of
    jax.jit on dense random operands (`tools/xla_dot_order.py check M K N`
    holds the rule to XLA at any shape).  Another XLA, or a CPU without
    AVX-512, may sum in another order.
    - m, n, k all <= 7: XLA's own loop, one chain over k.
    - m > 50: YNNPACK's cheapest kernel (`_ynn_best`); checked at random
      shapes up to m 1000 and k 1500, and its k-blocks up to k 4200.  A k
      under 4 sums as one chain (measured for n > 8; at k 2-3 with n <= 8
      a few results in a hundred differ: not modelled).
    - m <= 50 (measured, not derived; checked for k up to 600): 4 lanes
      while n <= 16, except at the k where padding k to a multiple of 4
      costs too much (k < 4; k = 5 once n > 4; k in 6, 9, 10, 13, 17 once
      n > 8), and for m <= 3 with n <= 3; else one chain.  k-blocks of
      2048 for one chain, of 8192, 4096 or 2048 for 4 lanes as n is at most
      4, 12 or 16.  Past k 600 XLA splits k at other places here (not
      modelled).
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


class Band(NamedTuple):
    """One axis of a resize as XLA sums it: for every output, `blocks`
    k-blocks, each `lanes` chains of up to `steps` taps and up to `lanes`
    tail taps (ops/kernels.banded_resize_plain gives the order).  idx is
    -1 where a slot holds no tap."""
    idx: torch.Tensor       # (dst, slots) int32
    weight: torch.Tensor    # (dst, slots) float32
    blocks: int
    lanes: int
    steps: int


@functools.lru_cache(maxsize=None)
def _band_host(kind: str, src: int, dst: int, lanes: int, k_block: int):
    """Host tables of `Band` for the (dst, src) weights of `kind`, summed
    with `lanes` partial sums in k-blocks of `k_block`."""
    w = (area_weights if kind == "area" else linear_weights)(src, dst)
    w = w.astype(np.float32)
    per_out = []
    for o in range(dst):
        blocks = {}
        for k in np.nonzero(w[o])[0]:
            lo = k // k_block * k_block
            hi = min(src, lo + k_block)
            main_end = lo + (hi - lo) // lanes * lanes
            chains, tail = blocks.setdefault(lo, ([[] for _ in range(lanes)],
                                                  [None] * lanes))
            if k < main_end:
                chains[(k - lo) % lanes].append(int(k))
            else:
                tail[k - main_end] = int(k)
        per_out.append([blocks[lo] for lo in sorted(blocks)])
    n_blocks = max(len(b) for b in per_out)
    steps = max(len(c) for b in per_out for ch, _ in b for c in ch)
    width = lanes * steps + lanes
    idx = np.full((dst, n_blocks * width), -1, np.int32)
    for o, blocks in enumerate(per_out):
        for j, (chains, tail) in enumerate(blocks):
            base = j * width
            for c, chain in enumerate(chains):
                idx[o, base + c * steps: base + c * steps + len(chain)] = chain
            for t, k in enumerate(tail):
                if k is not None:
                    idx[o, base + lanes * steps + t] = k
    weight = np.where(idx >= 0, w[np.arange(dst)[:, None],
                                  np.maximum(idx, 0)], 0.0)
    return idx, weight.astype(np.float32), n_blocks, steps


@functools.lru_cache(maxsize=None)
def band(kind: str, src: int, dst: int, m: int,
         device: torch.device) -> Band:
    """The band of one resize axis whose dot has m rows, on `device`
    (cached: the tables are uploaded once per shape and device)."""
    lanes, k_block = xla_dot_plan(m, src, dst)
    idx, weight, n_blocks, steps = _band_host(kind, src, dst, lanes,
                                              k_block)
    return Band(torch.as_tensor(idx, device=device),
                torch.as_tensor(weight, device=device), n_blocks, lanes,
                steps)


def _dense_axis(x: torch.Tensor, axis: int, dst: int,
                kind: str) -> torch.Tensor:
    """One dense resize axis of a (P, H, W) float32 tensor: axis 1 is the
    reference's first einsum (its dot has P*W rows), axis 2 its second
    (P*H rows)."""
    p, h, w = x.shape
    src = x.shape[axis]
    m = p * (w if axis == 1 else h)
    return kernels.banded_resize(x, band(kind, src, dst, m, x.device),
                                 axis)


def resize2d(img: torch.Tensor, dst_hw, kind: str) -> torch.Tensor:
    """Resize the last two dims of `img` to dst_hw.

    kind: 'area' (OpenCV INTER_AREA downscale) or 'linear' (INTER_LINEAR).
    H is applied before W in both paths; the dense path resizes both axes
    whenever either is not on the fast path, as the reference does."""
    h, w = img.shape[-2], img.shape[-1]
    dh, dw = dst_hw
    if (dh, dw) == (h, w):
        return img
    fast_h = "id" if dh == h else _axis_fast(h, dh, kind, -2)
    fast_w = "id" if dw == w else _axis_fast(w, dw, kind, -1)
    if fast_h is not None and fast_w is not None:
        y = img
        if fast_h != "id":
            y = _down_axis(y, -2, dh, list(fast_h))
        if fast_w != "id":
            y = _down_axis(y, -1, dw, list(fast_w))
        return y
    lead = img.shape[:-2]
    y = _dense_axis(img.reshape(-1, h, w).contiguous(), 1, dh, kind)
    y = _dense_axis(y, 2, dw, kind)
    return y.reshape(*lead, dh, dw)
