"""The adaptive edge-aware codec, written plainly in PyTorch and NumPy.

This is the benchmark's yardstick for what the codec under test produces.
It follows the reference codec (src/jpeg/jpeg.py, src/jpeg/quadtree.py of
fevzibabaoglu/adaptive-edge-aware-jpeg): sRGB -> colour space -> per-layer
INTER_AREA downsample -> edge map -> quadtree of leaf blocks -> per leaf
DCT-II, quantize, zigzag; and back: dequantize, DCT-III, paint, crop,
denormalize, INTER_LINEAR upsample, inverse colour, clip.

Precision.  `prec="reference"` computes a matrix space's colour
conversion and the area downsample in float32 in the codec's order (they
feed a truncation to uint8, whose result the codec defines at float32) and
every DCT, quantize and the whole decode in float64; a space with a file
of its own (spaces/<name>.py) says how it converts.  `prec="tf32"` is the
control: every contraction (colour matrix, resize, DCT, inverse DCT) takes
operands rounded to TF32 (10 mantissa bits, as the tensor cores read
float32) and accumulates in float32; quantize divides in float32.

Images are (N, H, W, 3) uint8 tensors.  A layer's leaves are a dict
{size: (ys, xs, levels)}, numpy int64 origins and (n, s*s) int64 zigzag
levels, in any order.
"""

import functools
import importlib
import json
import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import canny

SPACES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "spaces")

# JPEG Annex K base matrices (reference src/jpeg/jpeg.py:40-59)
LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61], [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56], [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77], [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101], [72, 92, 95, 98, 112, 100, 103, 99],
], np.float64)
CHROMA = np.full((8, 8), 99.0)
CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                  [47, 66, 99, 99]]

Leaves = Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]


@functools.lru_cache(maxsize=None)
def space(name: str) -> dict:
    """A colour space: "from_srgb" (x, prec) -> float32 layers and
    "to_srgb" (ycc, prec) -> sRGB, "mid", "scale" (float32 (3,)) and
    "ratios".  From spaces/<name>.json, 3x3 matrices (`convert` and
    `matrix_to_srgb`), or spaces/<name>.py, a module with `from_srgb`,
    `to_srgb`, MIDPOINTS, SCALES and DOWNSAMPLING (a space that is not
    linear)."""
    f32 = lambda v: np.asarray(v, np.float64).astype(np.float32)  # noqa
    if os.path.exists(os.path.join(SPACES_DIR, f"{name}.py")):
        mod = importlib.import_module(f"{__package__}.spaces.{name}")
        return {"from_srgb": mod.from_srgb, "to_srgb": mod.to_srgb,
                "mid": f32(mod.MIDPOINTS), "scale": f32(mod.SCALES),
                "ratios": [tuple(r) for r in mod.DOWNSAMPLING]}
    path = os.path.join(SPACES_DIR, f"{name}.json")
    if not os.path.exists(path):
        raise NotImplementedError(f"the reference has no colour space "
                                  f"{name!r} (add {path}, or a .py)")
    with open(path) as f:
        d = json.load(f)
    m_from, m_to = f32(d["from_srgb"]), f32(d["to_srgb"])
    return {"from_srgb": lambda x, prec: convert(x, m_from, prec),
            "to_srgb": lambda ycc, prec: matrix_to_srgb(ycc, m_to, prec),
            "mid": f32(d["midpoints"]), "scale": f32(d["scales"]),
            "ratios": [tuple(r) for r in d["downsampling"]]}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, nearest even)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


def _operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    return tf32(x) if prec == "tf32" else x


def _dtype(prec: str) -> torch.dtype:
    return torch.float32 if prec == "tf32" else torch.float64


# ------------------------------------------------------------ host tables


def largest_power_of_2(n: int) -> int:
    return n if n <= 2 else 2 ** int(math.floor(math.log2(n - 1)))


def root_size(h: int, w: int) -> int:
    return largest_power_of_2(max(h, w)) * 2


def block_sizes(lo: int, hi: int) -> List[int]:
    return [2 ** i for i in range(int(math.log2(lo)), int(math.log2(hi)) + 1)]


def quality_for(s: int, bs_range, q_range) -> int:
    """Per-size quality, log-interpolated (reference jpeg.py:688-705)."""
    (min_bs, max_bs), (min_q, max_q) = bs_range, q_range
    if min_bs == max_bs:
        return int((min_q + max_q) / 2)
    return int(min_q + (max_q - min_q) * (
        1 - math.log(s / min_bs) / math.log(max_bs / min_bs)))


@functools.lru_cache(maxsize=None)
def linear_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) INTER_LINEAR weights: src_x = (dst_x + 0.5) * src / dst
    - 0.5, clamped at the edges."""
    w = np.zeros((dst, src))
    if src == 1:
        w[:, 0] = 1.0
        return w
    for d in range(dst):
        fx = (d + 0.5) * src / dst - 0.5
        sx = int(np.floor(fx))
        fx -= sx
        if sx < 0:
            sx, fx = 0, 0.0
        if sx >= src - 1:
            sx, fx = src - 2, 1.0
        w[d, sx] += 1.0 - fx
        w[d, sx + 1] += fx
    return w


@functools.lru_cache(maxsize=None)
def area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) INTER_AREA weights of a downscale."""
    w = np.zeros((dst, src))
    scale = src / dst
    for d in range(dst):
        lo, hi = d * scale, (d + 1) * scale
        for c in range(int(np.floor(lo)), min(int(np.ceil(hi)), src)):
            w[d, c] = (min(c + 1.0, hi) - max(float(c), lo)) / scale
    return w


@functools.lru_cache(maxsize=None)
def qmatrix(layer: int, s: int, quality: int) -> np.ndarray:
    """(s, s) int quantization matrix (reference jpeg.py:707-724)."""
    base = LUMA if layer == 0 else CHROMA
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    scaled = np.floor((scale * base + 50.0) / 100.0)
    wl = linear_weights(8, s)
    return np.clip(wl @ scaled @ wl.T, 1.0, None).astype(np.int64)


@functools.lru_cache(maxsize=None)
def zigzag(s: int) -> np.ndarray:
    """Raster index of each zigzag position (reference jpeg.py:726-766)."""
    out = np.empty(s * s, np.int64)
    r = c = 0
    for i in range(s * s):
        out[i] = r * s + c
        if (r + c) % 2 == 0:
            if c == s - 1:
                r += 1
            elif r == 0:
                c += 1
            else:
                r, c = r - 1, c + 1
        else:
            if r == s - 1:
                c += 1
            elif c == 0:
                r += 1
            else:
                r, c = r + 1, c - 1
    return out


@functools.lru_cache(maxsize=None)
def dct_matrix(s: int) -> np.ndarray:
    """Orthonormal DCT-II matrix D[k, n] (OpenCV's definition)."""
    n = np.arange(s, dtype=np.float64)
    d = np.cos(np.pi * (2 * n[None, :] + 1) * n[:, None] / (2 * s))
    d *= np.sqrt(2.0 / s)
    d[0, :] = np.sqrt(1.0 / s)
    return d


# --------------------------------------------------------------- encode


def unit(u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 k / 255, correctly rounded."""
    lut = torch.tensor((np.arange(256) / 255.0).astype(np.float32),
                       device=u8.device)
    return lut[u8.to(torch.int64)]


def convert(x: torch.Tensor, m: np.ndarray, prec: str) -> torch.Tensor:
    """(..., 3) @ m.T, summed left to right in float32."""
    x = _operand(x.to(torch.float32), prec)
    m = _operand(torch.tensor(m, device=x.device), prec).tolist()
    return torch.stack([(x[..., 0] * m[j][0] + x[..., 1] * m[j][1])
                        + x[..., 2] * m[j][2] for j in range(3)], -1)


def matrix_to_srgb(ycc: torch.Tensor, m: np.ndarray, prec: str
                   ) -> torch.Tensor:
    """(..., 3) @ m.T in ycc's dtype (the decode's last contraction)."""
    dt = ycc.dtype
    m = _operand(torch.tensor(m, device=ycc.device), prec).to(dt)
    return _operand(ycc, prec).to(dt) @ m.T


def area_down(x: torch.Tensor, dst: Tuple[int, int], prec: str
              ) -> torch.Tensor:
    """INTER_AREA downsample of (N, h, w) float32 planes, rows first.  An
    exact power-of-two ratio on an axis averages its r cells in float32
    (pairwise down the rows, left to right along a row, as the codec sums
    them); any other ratio takes float64 weights."""
    x = _operand(x, prec)
    n, h, w = x.shape
    dh, dw = dst
    if (dh, dw) == (h, w):
        return x
    exact = [h % dh == 0 and (h // dh) & (h // dh - 1) == 0,
             w % dw == 0 and (w // dw) & (w // dw - 1) == 0]
    if not all(exact):
        wh = torch.tensor(area_weights(h, dh), device=x.device)
        ww = torch.tensor(area_weights(w, dw), device=x.device)
        return (wh @ x.to(torch.float64) @ ww.T).to(torch.float32)
    r = h // dh
    if r > 1:
        terms = [x[:, i::r] * (1.0 / r) for i in range(r)]
        while len(terms) > 1:
            terms = [terms[i] + terms[i + 1] if i + 1 < len(terms)
                     else terms[i] for i in range(0, len(terms), 2)]
        x = terms[0]
    r = w // dw
    if r > 1:
        acc = x[:, :, 0::r] * (1.0 / r)
        for i in range(1, r):
            acc = acc + x[:, :, i::r] * (1.0 / r)
        x = acc
    return x


def layer_shapes(cfg: dict, shape: Tuple[int, int]):
    h, w = shape
    return [(h // rh, w // rw) for rh, rw in space(cfg["color_space"])
            ["ratios"]]


def plan(edge: np.ndarray, lo: int, hi: int) -> List[Dict[int, tuple]]:
    """Quadtree leaves of (P, h, w) bool edge maps: a node splits when it
    is larger than `hi`, or larger than `lo` and holds an edge; a node
    whose origin lies outside the layer is absent.  -> per plane
    {size: (ys, xs)}."""
    p, h, w = edge.shape
    root = root_size(h, w)
    lmax = root.bit_length() - 1
    kmin = min(lo.bit_length() - 1, lmax)
    pyr = np.zeros((p, root, root), bool)
    pyr[:, :h, :w] = edge
    has = {0: pyr}
    for k in range(1, lmax + 1):
        g = root >> k
        has[k] = has[k - 1].reshape(p, g, 2, g, 2).any(axis=(2, 4))
    out = [dict() for _ in range(p)]
    visited = np.ones((p, 1, 1), bool)
    for k in range(lmax, kmin - 1, -1):
        s, g = 1 << k, root >> k
        at = np.arange(g) * s
        exists = (at[:, None] < h) & (at[None, :] < w)
        live = visited & exists[None]
        if k > kmin and s > hi:
            split = live
        elif k > kmin and s > lo:
            split = live & has[k]
        else:
            split = np.zeros_like(live)
        pi, yi, xi = np.nonzero(live & ~split)
        for q in np.unique(pi):
            sel = pi == q
            out[q][s] = (yi[sel] * s, xi[sel] * s)
        visited = split.repeat(2, axis=1).repeat(2, axis=2)
    return out


def _reflect(origins: torch.Tensor, s: int, limit: int) -> torch.Tensor:
    """(n,) block origins -> (n, s) indices, the tail past `limit`
    reflected (np.pad 'reflect', reference jpeg.py:398-402)."""
    offs = torch.arange(s, device=origins.device)[None, :]
    avail = torch.clamp(limit - origins, min=1)[:, None]
    period = torch.clamp(2 * avail - 2, min=1)
    m = offs % period
    return origins[:, None] + torch.where(m < avail, m, period - m)


def dct2(blocks: torch.Tensor, inverse: bool, prec: str) -> torch.Tensor:
    """D X D^T (forward) or D^T X D (inverse) of (n, s, s) blocks."""
    s = blocks.shape[-1]
    dt = _dtype(prec)
    d = torch.tensor(dct_matrix(s), dtype=dt, device=blocks.device)
    d = _operand(d, prec).to(dt)
    a, b = (d.T, d) if inverse else (d, d.T)
    y = a @ _operand(blocks.to(dt), prec).to(dt)
    return _operand(y, prec).to(dt) @ b


def levels_of(norm: torch.Tensor, li: int, leaves: dict, cfg: dict,
              prec: str) -> Dict[int, np.ndarray]:
    """Quantized zigzag levels of one layer's leaves: norm (N, h, w),
    leaves {s: (pidx, ys, xs)} -> {s: (n, s*s) int64}."""
    _, h, w = norm.shape
    dev = norm.device
    out = {}
    for s, (pidx, ys, xs) in leaves.items():
        pidx_t = torch.as_tensor(pidx, device=dev)
        rows = _reflect(torch.as_tensor(ys, device=dev), s, h)
        cols = _reflect(torch.as_tensor(xs, device=dev), s, w)
        blocks = norm[pidx_t[:, None, None], rows[:, :, None],
                      cols[:, None, :]]
        coef = dct2(blocks, False, prec)
        q = qmatrix(li, s, quality_for(max(s, cfg["block_size_range"][0]),
                                       cfg["block_size_range"],
                                       cfg["quality_range"]))
        lv = torch.round(coef / torch.tensor(q, dtype=coef.dtype,
                                              device=dev))
        zz = torch.as_tensor(zigzag(s), device=dev)
        out[s] = lv.reshape(len(pidx), s * s)[:, zz].to(torch.int64) \
            .cpu().numpy()
    return out


def layers_of(images: torch.Tensor, cfg: dict, prec: str):
    """(N, H, W, 3) uint8 -> the three (N, lh, lw) float32 layer stacks."""
    x = space(cfg["color_space"])["from_srgb"](unit(images), prec)
    shapes = layer_shapes(cfg, images.shape[1:3])
    return [area_down(x[..., i].contiguous(), shapes[i], prec)
            for i in range(3)]


def encode(images: torch.Tensor, cfg: dict, prec: str = "reference"
           ) -> List[List[Leaves]]:
    """(N, H, W, 3) uint8 -> per image, per layer, {s: (ys, xs, levels)}.
    cfg: color_space, quality_range, block_size_range."""
    sp = space(cfg["color_space"])
    lo, hi = cfg["block_size_range"]
    n = images.shape[0]
    out = [[None] * 3 for _ in range(n)]
    for li, layer in enumerate(layers_of(images, cfg, prec)):
        if lo == hi:
            edge = np.zeros(layer.shape, bool)
        else:
            edge = canny.edges(layer).cpu().numpy()
        plans = plan(edge, lo, hi)
        norm = (layer - float(sp["mid"][li])) * float(sp["scale"][li])
        grouped = {}
        for s in sorted({s for pl in plans for s in pl}):
            parts = [(np.full(len(pl[s][0]), i), *pl[s])
                     for i, pl in enumerate(plans) if s in pl]
            grouped[s] = tuple(np.concatenate(c) for c in zip(*parts))
        lv = levels_of(norm, li, grouped, cfg, prec)
        for i in range(n):
            out[i][li] = {}
        for s, (pidx, ys, xs) in grouped.items():
            for i in np.unique(pidx):
                sel = pidx == i
                out[i][li][s] = (ys[sel], xs[sel], lv[s][sel])
    return out


# --------------------------------------------------------------- decode


def decode(layers: List[Leaves], cfg: dict, shape: Tuple[int, int],
           device, prec: str = "reference") -> torch.Tensor:
    """One image's leaves -> (H, W, 3) sRGB in [0, 1] (float64, or
    float32 under the control)."""
    sp = space(cfg["color_space"])
    dt = _dtype(prec)
    h, w = shape
    lo = cfg["block_size_range"][0]
    planes = []
    for li, ((lh, lw), leaves) in enumerate(zip(layer_shapes(cfg, shape),
                                                 layers)):
        root = root_size(lh, lw)
        canvas = torch.zeros((root, root), dtype=dt, device=device)
        for s, (ys, xs, lv) in leaves.items():
            q = qmatrix(li, s, quality_for(max(s, lo),
                                           cfg["block_size_range"],
                                           cfg["quality_range"]))
            raster = torch.empty((len(ys), s * s), dtype=dt, device=device)
            raster[:, torch.as_tensor(zigzag(s), device=device)] = \
                torch.as_tensor(lv, device=device).to(dt)
            coef = raster.reshape(-1, s, s) * torch.tensor(q, dtype=dt,
                                                           device=device)
            rec = dct2(coef, True, prec)
            offs = torch.arange(s, device=device)
            r = torch.as_tensor(ys, device=device)[:, None] + offs
            c = torch.as_tensor(xs, device=device)[:, None] + offs
            canvas[r[:, :, None], c[:, None, :]] = rec.to(dt)
        layer = canvas[:lh, :lw] / float(sp["scale"][li]) \
            + float(sp["mid"][li])
        if (lh, lw) != (h, w):
            wh = _operand(torch.tensor(linear_weights(lh, h), dtype=dt,
                                       device=device), prec).to(dt)
            ww = _operand(torch.tensor(linear_weights(lw, w), dtype=dt,
                                       device=device), prec).to(dt)
            layer = _operand(wh @ _operand(layer, prec).to(dt), prec) \
                .to(dt) @ ww.T
        planes.append(layer)
    return torch.clamp(sp["to_srgb"](torch.stack(planes, -1), prec),
                       0.0, 1.0)
