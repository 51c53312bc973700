"""Separable resizes: OpenCV INTER_AREA down / INTER_LINEAR up.

Counterpart of the JAX package's ops/resize.py.  The exact OpenCV row and
column weights are precomputed on the host in float64.  Exact integer-ratio
downscales (4:2:0 chroma: 2x per axis; 4:1:1: 4x on width) take a grouped
fast path with the same f32 weights (powers of two, so every product is
exact) and a fixed accumulation order: sequential on W, pairwise on H.

Every other resize is the reference's pair of float32 einsums, H then W.
XLA compiles each into a 2-D dot, (b*w, h) @ Wh^T and then (b*dh, w) @
Ww^T, and its CPU backend hands the dot to YNNPACK, whose kernel sums in
an order that depends on the shape (ops/xla_dot.py).  The port computes
the same sums over the few non-zero taps of each output (the band):
FMAs that round once, in XLA's order, with its flush-to-zero.  The same
ops run on both devices (`ops/kernels.banded_resize`), so a resize gives
the same bits on the card as on the CPU.  No matmul library takes part.
"""

import functools
import numpy as np
import torch

from . import kernels
from .xla_dot import Band, make_band, xla_dot_plan  # noqa: F401 (the plan)


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


@functools.lru_cache(maxsize=None)
def band(kind: str, src: int, dst: int, m: int,
         device: torch.device) -> Band:
    """The band of one resize axis whose dot has m rows, on `device`
    (cached: the tables are uploaded once per shape and device)."""
    w = (area_weights if kind == "area" else linear_weights)(src, dst)
    return make_band(w.astype(np.float32), m, device)


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
