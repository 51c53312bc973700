"""PSNR / SSIM / MS-SSIM with the reference's metric semantics.

Counterpart of the JAX package's metrics/quality.py.  The reference uses
piq: piq.psnr on RGB floats with data_range 1.0, piq.ssim on OpenCV-grayscale
uint8 with data_range 255, piq.multi_scale_ssim on RGB floats
(src/image/evaluation_metrics.py:50-109).  Same definitions here:

 - gaussian window 11, sigma 1.5, k1=0.01, k2=0.03, valid-mode filtering
   (separable, taps summed in order)
 - piq's input downsampling: f = max(1, round(min(H, W) / 256)) average
   pool before SSIM
 - MS-SSIM: Wang et al. 5-scale weights, relu'd cs terms
 - the grayscale quirk: cv2 RGB2GRAY uint8 fixed-point rounding

The variance terms E[x^2] - mu^2 cancel, so their rounding shows in the
result.  The JAX package runs these functions op by op, unjitted, so each
product and sum is rounded on its own (no FMA); the port computes them the
same way and in the same order.  LPIPS lives in metrics/lpips.py.
"""

import functools
from typing import Optional

import numpy as np
import torch

from .. import resolve_device

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr(x: torch.Tensor, y: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """PSNR over all pixels/channels of one image (H, W, C) or (H, W); the
    mean squared error is accumulated in float64 and rounded once."""
    d = x.to(torch.float32) - y.to(torch.float32)
    mse = torch.mean((d * d).to(torch.float64)).to(torch.float32)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def rgb_to_gray_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """OpenCV cvtColor(RGB2GRAY) on uint8: BT.601 weights in Q15 fixed
    point with round-half-up (the installed cv2 5.0's arithmetic)."""
    r, g, b = (rgb_u8[..., i].to(torch.int32) for i in range(3))
    return ((9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15).to(
        torch.uint8)


@functools.lru_cache(maxsize=None)
def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k /= k.sum()
    return k.astype(np.float32)


def _filter_valid(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable valid-mode filtering over the last two dims of (C, H, W):
    rows then columns, each a sequential sum of the taps."""
    n = k.shape[0]
    h = img.shape[-2] - n + 1
    out = img[..., 0:h, :] * float(k[0])
    for i in range(1, n):
        out = out + float(k[i]) * img[..., i:h + i, :]
    w = out.shape[-1] - n + 1
    img = out
    out = img[..., :, 0:w] * float(k[0])
    for i in range(1, n):
        out = out + float(k[i]) * img[..., :, i:w + i]
    return out


def _avg_pool(img: torch.Tensor, f: int) -> torch.Tensor:
    """(..., H, W) average pool with stride f (floor sizes, F.avg_pool2d
    semantics), rounded as XLA computes the JAX package's mean: the window
    summed in raster order, times the float32 reciprocal of f*f."""
    h, w = img.shape[-2:]
    hh, ww = h // f, w // f
    v = img[..., :hh * f, :ww * f].reshape(*img.shape[:-2], hh, f, ww, f)
    acc = v[..., 0, :, 0]
    for k in range(1, f * f):
        acc = acc + v[..., k // f, :, k % f]
    return acc * float(np.float32(1) / np.float32(f * f))


def _mean32(t: torch.Tensor, dims) -> torch.Tensor:
    t = t.to(torch.float64)
    return (t.mean() if dims is None else t.mean(dim=dims)).to(torch.float32)


def _ssim_components(x: torch.Tensor, y: torch.Tensor, data_range: float,
                     k1=0.01, k2=0.03, dims=None):
    """(C, H, W) inputs -> (mean ssim, mean cs) over the valid map; with
    `dims`, (..., C, H, W) inputs and means over those dims only.  The
    maps match the JAX package's bit for bit; their means are accumulated
    in float64 and rounded once, where JAX's float32 mean drifts (8e-6 on
    a (3, 27, 30) map)."""
    c1 = float(np.float32((k1 * data_range) ** 2))
    c2 = float(np.float32((k2 * data_range) ** 2))
    k = _gaussian_window()
    mu_x = _filter_valid(x, k)
    mu_y = _filter_valid(y, k)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_x = _filter_valid(x * x, k) - mu_xx
    sigma_y = _filter_valid(y * y, k) - mu_yy
    sigma_xy = _filter_valid(x * y, k) - mu_xy
    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return _mean32(ssim_map, dims), _mean32(cs, dims)


def _to_chw(img: torch.Tensor) -> torch.Tensor:
    img = img.to(torch.float32)
    return img[None] if img.dim() == 2 else img.permute(2, 0, 1)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         downsample: bool = True) -> torch.Tensor:
    """SSIM (piq semantics incl. the initial f = round(min(H,W)/256)
    average-pool downsample) of (H, W, C) or (H, W) images."""
    xc, yc = _to_chw(x), _to_chw(y)
    if downsample:
        f = max(1, round(min(xc.shape[-2], xc.shape[-1]) / 256))
        if f > 1:
            xc = _avg_pool(xc, f)
            yc = _avg_pool(yc, f)
    return _ssim_components(xc, yc, data_range)[0]


def _check_ms_ssim_size(xc: torch.Tensor, levels: int) -> None:
    min_side = (11 - 1) * 2 ** (levels - 1) + 1
    if min(xc.shape[-2:]) < min_side:
        raise ValueError(
            f"ms_ssim requires images of at least {min_side}px per side "
            f"(got {tuple(xc.shape[-2:])}); piq imposes the same bound")


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
            weights=MS_SSIM_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM (Wang et al.; piq.multi_scale_ssim semantics with
    relu'd components)."""
    xc, yc = _to_chw(x), _to_chw(y)
    levels = len(weights)
    _check_ms_ssim_size(xc, levels)
    out = torch.ones((), dtype=torch.float32, device=xc.device)
    for i, wgt in enumerate(weights):
        s, cs = _ssim_components(xc, yc, data_range)
        out = out * torch.clamp(s if i == levels - 1 else cs, min=0.0) ** wgt
        if i < levels - 1:
            xc = _avg_pool(xc, 2)
            yc = _avg_pool(yc, 2)
    return out


def psnr_batch(x: torch.Tensor, y: torch.Tensor,
               data_range: float = 1.0) -> torch.Tensor:
    """psnr of each image of (B, ...) batches -> (B,)."""
    d = x.to(torch.float32) - y.to(torch.float32)
    mse = _mean32((d * d).flatten(1), 1)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def ssim_batch(x: torch.Tensor, y: torch.Tensor,
               data_range: float = 1.0) -> torch.Tensor:
    """ssim of each (H, W) image of (B, H, W) batches -> (B,)."""
    xc, yc = x.to(torch.float32)[:, None], y.to(torch.float32)[:, None]
    f = max(1, round(min(xc.shape[-2], xc.shape[-1]) / 256))
    if f > 1:
        xc = _avg_pool(xc, f)
        yc = _avg_pool(yc, f)
    return _ssim_components(xc, yc, data_range, dims=(1, 2, 3))[0]


def ms_ssim_batch(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
                  weights=MS_SSIM_WEIGHTS) -> torch.Tensor:
    """ms_ssim of each (H, W, C) image of (B, H, W, C) batches -> (B,)."""
    xc = x.to(torch.float32).permute(0, 3, 1, 2)
    yc = y.to(torch.float32).permute(0, 3, 1, 2)
    levels = len(weights)
    _check_ms_ssim_size(xc, levels)
    out = torch.ones(xc.shape[0], dtype=torch.float32, device=xc.device)
    for i, wgt in enumerate(weights):
        s, cs = _ssim_components(xc, yc, data_range, dims=(1, 2, 3))
        out = out * torch.clamp(s if i == levels - 1 else cs, min=0.0) ** wgt
        if i < levels - 1:
            xc = _avg_pool(xc, 2)
            yc = _avg_pool(yc, 2)
    return out


class EvaluationMetrics:
    """psnr / ssim / ms_ssim / lpips of a pair of ImageData-likes (float32
    [0,1] HWC), as the reference's EvaluationMetrics
    (src/image/evaluation_metrics.py:31-139).

    device: None means CUDA (raises when CUDA is absent); pass "cpu" for
    the plain PyTorch path."""

    def __init__(self, original, compressed,
                 lpips_weights: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self._a = np.asarray(getattr(original, "data", original), np.float32)
        self._b = np.asarray(getattr(compressed, "data", compressed),
                             np.float32)
        self._lpips_weights = lpips_weights

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def psnr(self) -> float:
        return float(psnr(self._dev(self._a), self._dev(self._b), 1.0))

    def ssim(self) -> float:
        ga = rgb_to_gray_u8(self._dev((self._a * 255).astype(np.uint8)))
        gb = rgb_to_gray_u8(self._dev((self._b * 255).astype(np.uint8)))
        return float(ssim(ga.to(torch.float32), gb.to(torch.float32),
                          data_range=255.0))

    def ms_ssim(self) -> float:
        return float(ms_ssim(self._dev(self._a), self._dev(self._b), 1.0))

    def lpips(self) -> float:
        from .lpips import lpips_distance
        return float(lpips_distance(self._a, self._b,
                                    weights_path=self._lpips_weights,
                                    device=self.device))
