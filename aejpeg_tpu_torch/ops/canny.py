"""Edge detection stack (CLAHE -> Gaussian -> bilateral -> Canny), batched
over planes.

Counterpart of the JAX package's ops/canny.py, where the stack runs per
plane under jax.vmap; here every stage takes a (P, H, W) batch of planes.
Stages follow the reference preprocessing + Canny pipeline
(src/jpeg/edge_detection.py:28-86) with OpenCV's uint8 semantics:

  1. scale x255 -> uint8 (wrapping cast: negative chroma wraps)
  2. CLAHE, clip 0.75, 4x4 tiles
  3. 3x3 Gaussian blur, 8-bit fixed point
  4. bilateral filter d=5, sigma_color=75, sigma_space=75
  5. thresholds = 10th/30th percentile of the filtered image
  6. Canny: Sobel aperture 3, L2 gradient, NMS, hysteresis

The 256-bin histograms (CLAHE tiles, percentiles), the CLAHE LUT
application, the bilateral filter's taps and the hysteresis run through
the kernels of ops/kernels.py.  Output is float32 {0, 1}.
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .dfloat import expf_xla
from .kernels import (bilateral, clahe_apply_gather,
                      clahe_gather_supported, clahe_lut_apply, disk,
                      histogram256, hysteresis, reflect101_pad)


# --------------------------------------------------------------- uint8 cast
def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """(img * 255).astype(np.uint8) with C-cast wrap-around parity: truncate
    toward zero, then keep the low byte (negative chroma wraps)."""
    return torch.trunc(img * 255.0).to(torch.int32).to(torch.uint8)


# -------------------------------------------------------------------- CLAHE
def _clahe_luts(padded: torch.Tensor, th: int, tw: int, gh: int, gw: int,
                clip_limit: float) -> torch.Tensor:
    """(P, gh*th, gw*tw) uint8 -> (P, gh, gw, 256) f32 per-tile LUTs, OpenCV
    semantics: histogram clip + redistribution (residual spread with
    step = histSize/residual), then scaled cumsum with round-half-away."""
    p = padded.shape[0]
    tiles = padded.reshape(p, gh, th, gw, tw).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(p, gh * gw, th * tw).to(torch.int32)
    hist = histogram256(tiles).to(torch.int64)               # (P, T, 256)

    tile_area = th * tw
    clip = max(int(clip_limit * tile_area / 256), 1)
    clipped = torch.clamp(hist, max=clip)
    excess = (hist - clipped).sum(dim=-1)                    # (P, T)
    batch = excess // 256
    residual = excess - batch * 256
    h2 = clipped + batch[..., None]
    step = torch.clamp(torch.where(
        residual > 0, 256 // torch.clamp(residual, min=1),
        torch.full_like(residual, 256)), min=1)
    idx = torch.arange(256, device=padded.device)
    gets_one = ((idx % step[..., None] == 0)
                & (idx // step[..., None] < residual[..., None]))
    h3 = h2 + gets_one.to(torch.int64)

    csum = torch.cumsum(h3, dim=-1)
    lut = torch.clamp(torch.floor(csum * (255.0 / tile_area) + 0.5), 0, 255)
    return lut.reshape(p, gh, gw, 256).to(torch.float32)


def _clahe_tile_weights(h: int, w: int, th: int, tw: int, gh: int,
                        gw: int) -> np.ndarray:
    """(h, w, gh*gw) float32 bilinear weights of each tile LUT per pixel
    (4 nonzero per pixel), the JAX package's host table (not cached: only
    _clahe_taps' 4-wide extract of it is kept)."""
    ty = np.arange(h, dtype=np.float64) / th - 0.5
    tx = np.arange(w, dtype=np.float64) / tw - 0.5
    y0 = np.floor(ty).astype(np.int64)
    x0 = np.floor(tx).astype(np.int64)
    fy = ty - y0
    fx = tx - x0
    wts = np.zeros((h, w, gh * gw), np.float64)
    yy = np.arange(h)
    xx = np.arange(w)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        yc = np.clip(y0 + dy, 0, gh - 1)
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xc = np.clip(x0 + dx, 0, gw - 1)
            t = yc[:, None] * gw + xc[None, :]
            np.add.at(wts, (yy[:, None], xx[None, :], t),
                      wy[:, None] * wx[None, :])
    return wts.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _clahe_taps(h: int, w: int, th: int, tw: int, gh: int, gw: int):
    """The 4 taps of every pixel for clahe_lut_apply: (h, 2) tile rows,
    (w, 2) tile columns and (h, w, 4) f32 weights taken from
    _clahe_tile_weights.  Where clamping maps two taps to one tile, the
    first keeps the merged weight and the repeat gets 0."""
    wts = _clahe_tile_weights(h, w, th, tw, gh, gw)
    y0 = np.floor(np.arange(h, dtype=np.float64) / th - 0.5).astype(np.int64)
    x0 = np.floor(np.arange(w, dtype=np.float64) / tw - 0.5).astype(np.int64)
    iy = np.clip(np.stack([y0, y0 + 1], 1), 0, gh - 1).astype(np.int32)
    ix = np.clip(np.stack([x0, x0 + 1], 1), 0, gw - 1).astype(np.int32)
    taps = (iy[:, None, :, None] * gw + ix[None, :, None, :]).reshape(h, w, 4)
    tw4 = np.take_along_axis(wts, taps, axis=2)
    for j in range(1, 4):
        repeat = (taps[:, :, j:j + 1] == taps[:, :, :j]).any(axis=2)
        tw4[:, :, j][repeat] = 0.0
    return iy, ix, np.ascontiguousarray(tw4, np.float32)


@functools.lru_cache(maxsize=None)
def _clahe_interp_vectors(h: int, w: int, th: int, tw: int, gh: int,
                          gw: int):
    """Per-axis vectors for the gather kernel, same f64->f32 derivation as
    _clahe_tile_weights: clamped left/right tile-column indices and
    fractional weights per x, fractional weights per y (all 1-D)."""
    tx = np.arange(w, dtype=np.float64) / tw - 0.5
    x0f = np.floor(tx).astype(np.int64)
    xa = (tx - x0f).astype(np.float32)
    ix0 = np.clip(x0f, 0, gw - 1).astype(np.int32)
    ix1 = np.clip(x0f + 1, 0, gw - 1).astype(np.int32)
    ty = np.arange(h, dtype=np.float64) / th - 0.5
    ya = (ty - np.floor(ty)).astype(np.float32)
    return (ix0, ix1, xa, (1 - xa).astype(np.float32), ya,
            (1 - ya).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _device_tables(table, device: torch.device, *key) -> tuple:
    """The arrays of table(*key) (_clahe_interp_vectors or _clahe_taps) on
    `device`, uploaded once per (shape, tiling, device); complete before
    they are returned, so any stream may read them."""
    out = tuple(torch.as_tensor(a, device=device) for a in table(*key))
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return out


def clahe(img_u8: torch.Tensor, clip_limit: float = 0.75,
          grid=(4, 4)) -> torch.Tensor:
    """OpenCV-style CLAHE on (P, H, W) uint8: pad to a tile multiple
    (BORDER_REFLECT_101), per-tile clipped-histogram LUTs, bilinear LUT
    interpolation.  The packed-word gather kernel serves shapes that band
    by half tiles and rounds half-to-even (cvRound); the 4-tap fallback
    rounds floor(x + 0.5), as the JAX package's two branches do."""
    _, h, w = img_u8.shape
    gh, gw = grid
    th = -(-h // gh)
    tw = -(-w // gw)
    padded = reflect101_pad(img_u8, 0, th * gh - h, 0, tw * gw - w)
    luts = _clahe_luts(padded, th, tw, gh, gw, clip_limit)  # (P, gh, gw, 256)
    key = (img_u8.device, h, w, th, tw, gh, gw)
    img = img_u8.contiguous()

    if clahe_gather_supported(h, w, th, gh, gw):
        # byte c of word (row, v) = LUT of tile column c (little-endian)
        words = (luts.to(torch.uint8).permute(0, 1, 3, 2).contiguous()
                 .view(torch.int32).squeeze(-1))            # (P, gh, 256)
        vecs = _device_tables(_clahe_interp_vectors, *key)
        out = clahe_apply_gather(img, words, *vecs, th=th)
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)

    lut = luts.reshape(-1, gh * gw, 256)
    iy, ix, wts = _device_tables(_clahe_taps, *key)
    out = clahe_lut_apply(img, lut, iy, ix, wts, gw)
    return torch.clamp(torch.floor(out + 0.5), 0, 255).to(torch.uint8)


# ------------------------------------------------------------ gaussian blur
# OpenCV getGaussianKernel uses these fixed tables for ksize <= 7, sigma <= 0
# (smoothing's "small_gaussian_tab"), not the sigma formula.
_SMALL_GAUSSIAN = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_u8(ksize: int) -> np.ndarray:
    """Fixed-point (x256) Gaussian coefficients as OpenCV uses for uint8."""
    if ksize in _SMALL_GAUSSIAN:
        k = np.asarray(_SMALL_GAUSSIAN[ksize], np.float64)
    else:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
        x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
        k = np.exp(-(x * x) / (2 * sigma * sigma))
        k /= k.sum()
    return np.round(k * 256).astype(np.int32)


def gaussian_blur_u8(img_u8: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Gaussian on (P, H, W) uint8 with OpenCV's 8-bit fixed-point
    arithmetic and BORDER_REFLECT_101: rows then columns in int32, one
    rounding shift by 2^16."""
    kf = _gaussian_kernel_u8(ksize)
    r = ksize // 2
    h, w = img_u8.shape[-2:]
    padded = reflect101_pad(img_u8.to(torch.int32), r, r, r, r)
    rowsum = torch.zeros(padded.shape[:-1] + (w,), dtype=torch.int32,
                         device=img_u8.device)
    for j in range(ksize):
        rowsum = rowsum + int(kf[j]) * padded[..., j:j + w]
    out = torch.zeros(img_u8.shape, dtype=torch.int32, device=img_u8.device)
    for i in range(ksize):
        out = out + int(kf[i]) * rowsum[..., i:i + h, :]
    out = (out + (1 << 15)) >> 16
    return torch.clamp(out, 0, 255).to(torch.uint8)


# ---------------------------------------------------------- bilateral filter
@functools.lru_cache(maxsize=None)
def _color_weights(sigma_color: float, device: torch.device) -> torch.Tensor:
    """The bilateral's colour weights by |d|, d the difference of two uint8
    pixels: XLA's exp(f32(d * d) * cc) (dfloat.expf_xla), a table so that
    the CPU and the card give its bits (torch.exp gives neither)."""
    cc = float(np.float32(-0.5 / (sigma_color * sigma_color)))
    d = torch.arange(256, dtype=torch.float32)
    return expf_xla(d * d * cc).to(device)


@functools.lru_cache(maxsize=None)
def _bilateral_taps(d: int, sigma_color: float, sigma_space: float):
    """The space weights of the disk's taps (`kernels.disk`, the
    reference's order) as float32 values, checked so that every nonzero
    weight f32(s_w * colour weight) the taps make is at least 2**-17."""
    radius = d // 2
    gauss_space_coeff = -0.5 / (sigma_space * sigma_space)
    offs, sw = [], []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            rr = math.sqrt(dy * dy + dx * dx)
            if rr > radius:
                continue
            offs.append((dy, dx))
            sw.append(math.exp(rr * rr * gauss_space_coeff))
    if offs != disk(radius):
        raise ValueError(f"bilateral: the disk of radius {radius} differs "
                         "from kernels.disk")
    sw = torch.tensor(np.asarray(sw, np.float32))
    weights = sw[:, None] * _color_weights(sigma_color, torch.device("cpu"))
    if bool(((weights != 0) & (weights < 2.0 ** -17)).any()):
        raise ValueError(f"bilateral: sigma_color={sigma_color} makes "
                         "colour weights below 2**-17")
    return tuple(sw.tolist())


def bilateral_u8(img_u8: torch.Tensor, d: int = 5, sigma_color: float = 75.0,
                 sigma_space: float = 75.0) -> torch.Tensor:
    """OpenCV bilateralFilter for uint8 single-channel planes: radius d//2,
    space weights exp(-r^2/(2 sc^2)) over the disk r <= radius, color
    weights exp(-diff^2/(2 scol^2)), float accumulation, round-half-away.

    Rounded as XLA compiles the JAX package's loop for the CPU: the weights
    are s_w * exp(...) with XLA's exp; the numerator starts as
    fma(w0, nb0, w1 * nb1) (LLVM fuses the first product of an add of two)
    and takes each further tap as fma(w, nb, num); the denominator adds
    the rounded weights.  The taps run in kernels.bilateral, which pads
    the planes itself."""
    space = _bilateral_taps(d, float(sigma_color), float(sigma_space))
    return bilateral(img_u8.contiguous(),
                     _color_weights(float(sigma_color), img_u8.device),
                     space, d // 2)


# ------------------------------------------------------------------- sobel
def sobel_xy(img_u8: torch.Tensor):
    """Sobel dx, dy (aperture 3) on (P, H, W) uint8 -> int32,
    BORDER_REFLECT_101 (OpenCV Canny's internal gradients)."""
    pd = reflect101_pad(img_u8.to(torch.int32), 1, 1, 1, 1)
    h, w = img_u8.shape[-2:]

    def sl(dy, dx):
        return pd[..., dy + 1:dy + 1 + h, dx + 1:dx + 1 + w]

    gx = (sl(-1, 1) - sl(-1, -1)) + 2 * (sl(0, 1) - sl(0, -1)) + \
         (sl(1, 1) - sl(1, -1))
    gy = (sl(1, -1) - sl(-1, -1)) + 2 * (sl(1, 0) - sl(-1, 0)) + \
         (sl(1, 1) - sl(-1, 1))
    return gx, gy


# ------------------------------------------------------------------- canny
def _canny_from_gradients(gx: torch.Tensor, gy: torch.Tensor,
                          low: torch.Tensor, high: torch.Tensor
                          ) -> torch.Tensor:
    """NMS + hysteresis, OpenCV L2 semantics, on (P, H, W) int32 gradients
    with per-plane (P,) squared thresholds: magnitude gx^2 + gy^2, sector
    choice in Q15 fixed point against tan(22.5) / tan(67.5)."""
    mag = (gx * gx + gy * gy).to(torch.float32)
    ax = torch.abs(gx)
    ay = torch.abs(gy) << 15
    tg22 = 13573                    # round(tan(22.5deg) * 2^15) per OpenCV
    tg67x = ax * (3 << 15)          # tan(67.5) = 2 + tan(22.5)
    h, w = mag.shape[-2:]
    pm = F.pad(mag, (1, 1, 1, 1))   # borders compare against 0

    def nb(dy, dx):
        return pm[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    horiz = (mag > nb(0, -1)) & (mag >= nb(0, 1))
    vert = (mag > nb(-1, 0)) & (mag >= nb(1, 0))
    diag1 = (mag > nb(-1, -1)) & (mag >= nb(1, 1))     # 135 deg
    diag2 = (mag > nb(-1, 1)) & (mag >= nb(1, -1))     # 45 deg
    sector_h = ay < tg22 * ax
    sector_v = ay > tg67x + tg22 * ax
    s_xor = (gx ^ gy) < 0
    nms = torch.where(sector_h, horiz,
                      torch.where(sector_v, vert,
                                  torch.where(s_xor, diag2, diag1)))
    strong = nms & (mag > high[:, None, None])
    weak = nms & (mag > low[:, None, None])
    return hysteresis(strong, weak)


# ------------------------------------------------------------- percentiles
def _percentile_from_hist(csum: torch.Tensor, n: int, q: float
                          ) -> torch.Tensor:
    pos = np.float32(q / 100.0 * (n - 1))
    k = int(np.floor(pos))
    frac = np.float32(pos - np.float32(k))
    # value at sorted index i = searchsorted(csum, i+1)
    ks = torch.full((csum.shape[0], 1), k + 1, dtype=csum.dtype,
                    device=csum.device)
    v0 = torch.searchsorted(csum, ks, side="left")[:, 0]
    v1 = (torch.searchsorted(csum, ks + 1, side="left")[:, 0]
          if k + 1 < n else v0)
    return (v0.to(torch.float32) * float(np.float32(1) - frac)
            + v1.to(torch.float32) * float(frac))


def percentiles_u8(img_u8: torch.Tensor, qs) -> tuple:
    """np.percentile per plane of (P, H, W) uint8 for several q's, from one
    256-bin histogram per plane (split into 8 rows, -1 padded)."""
    p = img_u8.shape[0]
    n = img_u8.shape[-2] * img_u8.shape[-1]
    flat = img_u8.reshape(p, n).to(torch.int32)
    pad = (-n) % 8
    if pad:
        flat = F.pad(flat, (0, pad), value=-1)
    hist = histogram256(flat.reshape(p, 8, -1)).sum(dim=1)   # (P, 256)
    csum = torch.cumsum(hist, dim=-1)
    return tuple(_percentile_from_hist(csum, n, q) for q in qs)


def canny(layers: torch.Tensor) -> torch.Tensor:
    """Full edge stack on (P, H, W) float32 planes -> {0,1} float32
    (src/jpeg/edge_detection.py:64-86)."""
    u8 = to_uint8(layers)
    eq = clahe(u8, 0.75, (4, 4))
    blur = gaussian_blur_u8(eq, 3)
    blur = bilateral_u8(blur, 5, 75.0, 75.0)
    low, high = percentiles_u8(blur, (10.0, 30.0))
    gx, gy = sobel_xy(blur)
    # OpenCV L2gradient squares the thresholds
    return _canny_from_gradients(gx, gy, low * low, high * high)
