"""The codec's edge stack, written plainly over a (P, h, w) stack of planes.

Stages, with OpenCV's uint8 semantics (the reference codec's
src/jpeg/edge_detection.py):

  1. x * 255 truncated to an int, low byte kept (negative chroma wraps)
  2. CLAHE, clip limit 0.75, 4 x 4 tiles, BORDER_REFLECT_101 padding
  3. 3 x 3 Gaussian in 8-bit fixed point
  4. bilateral filter, d = 5, sigma_color = sigma_space = 75
  5. thresholds at the 10th and 30th percentiles of the filtered plane
  6. Canny: Sobel aperture 3, L2 magnitude, non-maximum suppression,
     8-connected hysteresis

The arithmetic is float64 where the codec rounds to an integer (the CLAHE
blend, the bilateral's quotient), so the two agree except where a float32
rounding lands on the other side of a half.  The codec's own choices are
kept where they differ from OpenCV: its near-vertical sector bound is
|dy| * 2**15 > |dx| * (3 * 2**15 + 13573), and the CLAHE blend rounds half
to even on tilings whose half tile height is a multiple of 8 and half up
on the others.
"""

import math

import torch
import torch.nn.functional as F


def reflect101_index(n: int, before: int, after: int,
                     device) -> torch.Tensor:
    """Indices of BORDER_REFLECT_101 padding of an axis of length n."""
    i = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * n - 2
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def pad101(x: torch.Tensor, top: int, bottom: int, left: int,
           right: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    x = x[..., reflect101_index(h, top, bottom, x.device), :]
    return x[..., reflect101_index(w, left, right, x.device)]


def to_u8(planes: torch.Tensor) -> torch.Tensor:
    """float32 planes -> int64 values in [0, 255]: trunc(x * 255), wrapped."""
    return torch.trunc(planes * 255.0).to(torch.int64) & 255


def clahe(u8: torch.Tensor, clip_limit: float = 0.75, grid=(4, 4)
          ) -> torch.Tensor:
    p, h, w = u8.shape
    gh, gw = grid
    th, tw = -(-h // gh), -(-w // gw)
    area = th * tw
    padded = pad101(u8, 0, th * gh - h, 0, tw * gw - w)
    tiles = padded.reshape(p, gh, th, gw, tw).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(p * gh * gw, area)
    hist = torch.zeros((p * gh * gw, 256), dtype=torch.int64,
                       device=u8.device)
    hist.scatter_add_(1, tiles, torch.ones_like(tiles))
    clip = max(int(clip_limit * area / 256), 1)
    clipped = hist.clamp(max=clip)
    excess = (hist - clipped).sum(1)
    batch = excess // 256
    residual = excess - batch * 256
    step = torch.where(residual > 0, 256 // residual.clamp(min=1),
                       torch.full_like(residual, 256)).clamp(min=1)
    idx = torch.arange(256, device=u8.device)
    extra = (idx % step[:, None] == 0) & (idx // step[:, None]
                                          < residual[:, None])
    csum = torch.cumsum(clipped + batch[:, None] + extra.to(torch.int64), 1)
    scale = torch.tensor(255.0 / area, dtype=torch.float32, device=u8.device)
    lut = torch.floor(csum.to(torch.float32) * scale + 0.5).clamp(0, 255)
    lut = lut.to(torch.float64).reshape(p, gh, gw, 256)

    ty = torch.arange(h, dtype=torch.float64, device=u8.device) / th - 0.5
    tx = torch.arange(w, dtype=torch.float64, device=u8.device) / tw - 0.5
    y0, x0 = torch.floor(ty), torch.floor(tx)
    ya, xa = (ty - y0)[:, None], (tx - x0)[None, :]
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    ys = (y0.clamp(0, gh - 1), (y0 + 1).clamp(0, gh - 1))
    xs = (x0.clamp(0, gw - 1), (x0 + 1).clamp(0, gw - 1))
    flat = lut.reshape(-1)
    base = torch.arange(p, device=u8.device)[:, None, None] * (gh * gw * 256)

    def at(yi, xi):
        cell = (yi[:, None] * gw + xi[None, :]) * 256
        return flat[base + cell[None] + u8]

    top = at(ys[0], xs[0]) * (1 - xa) + at(ys[0], xs[1]) * xa
    bot = at(ys[1], xs[0]) * (1 - xa) + at(ys[1], xs[1]) * xa
    out = top * (1 - ya) + bot * ya
    if gw == 4 and th % 2 == 0 and (th // 2) % 8 == 0:
        out = torch.round(out)
    else:
        out = torch.floor(out + 0.5)
    return out.clamp(0, 255).to(torch.int64)


def gaussian3(u8: torch.Tensor) -> torch.Tensor:
    """3 x 3 Gaussian, OpenCV's 8-bit fixed point: taps 64, 128, 64 along
    rows, then columns, one rounding shift by 2**16."""
    h, w = u8.shape[-2:]
    x = pad101(u8, 1, 1, 1, 1)
    k = (64, 128, 64)
    rows = sum(k[j] * x[..., j:j + w] for j in range(3))
    out = sum(k[i] * rows[..., i:i + h, :] for i in range(3))
    return ((out + (1 << 15)) >> 16).clamp(0, 255)


def bilateral(u8: torch.Tensor, d: int = 5, sigma_color: float = 75.0,
              sigma_space: float = 75.0) -> torch.Tensor:
    """OpenCV's bilateralFilter on uint8 values: the disk of radius d // 2,
    weights exp(-r^2 / (2 ss^2)) * exp(-diff^2 / (2 sc^2)), the weighted
    mean rounded half up."""
    r = d // 2
    h, w = u8.shape[-2:]
    x = pad101(u8, r, r, r, r)
    centre = u8.to(torch.float64)
    num = torch.zeros_like(centre)
    den = torch.zeros_like(centre)
    cs = -0.5 / (sigma_space * sigma_space)
    cc = -0.5 / (sigma_color * sigma_color)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            rr = dy * dy + dx * dx
            if rr > r * r:
                continue
            nb = x[..., dy + r:dy + r + h, dx + r:dx + r + w].to(
                torch.float64)
            wt = math.exp(rr * cs) * torch.exp((nb - centre) ** 2 * cc)
            num += wt * nb
            den += wt
    return torch.floor(num / den + 0.5).clamp(0, 255).to(torch.int64)


def percentile(u8: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation percentile of each plane, in float32."""
    p = u8.shape[0]
    n = u8.shape[-2] * u8.shape[-1]
    srt = torch.sort(u8.reshape(p, n), dim=1).values
    pos = float(torch.tensor(q / 100.0 * (n - 1), dtype=torch.float32))
    k = int(math.floor(pos))
    frac = torch.tensor(pos - k, dtype=torch.float32).item()
    v0 = srt[:, k].to(torch.float32)
    v1 = srt[:, min(k + 1, n - 1)].to(torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    return v0 * float(one - frac) + v1 * frac


def _dilate8(m: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(m[:, None].to(torch.float32), 3, 1, 1)[:, 0] > 0


def hysteresis(strong: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """Strong pixels grown through weak ones, 8-connected, to the end."""
    cur = strong
    while True:
        prev = cur
        for _ in range(16):
            cur = cur | (weak & _dilate8(cur))
        if torch.equal(cur, prev):
            return cur


def edges(planes: torch.Tensor) -> torch.Tensor:
    """(P, h, w) float32 layer planes -> (P, h, w) bool edge maps."""
    u8 = to_u8(planes)
    blur = bilateral(gaussian3(clahe(u8)))
    low = percentile(blur, 10.0)
    high = percentile(blur, 30.0)
    h, w = blur.shape[-2:]
    x = pad101(blur, 1, 1, 1, 1)

    def sl(dy, dx):
        return x[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (sl(-1, 1) - sl(-1, -1)) + 2 * (sl(0, 1) - sl(0, -1)) \
        + (sl(1, 1) - sl(1, -1))
    gy = (sl(1, -1) - sl(-1, -1)) + 2 * (sl(1, 0) - sl(-1, 0)) \
        + (sl(1, 1) - sl(-1, 1))
    mag = gx * gx + gy * gy
    pm = F.pad(mag, (1, 1, 1, 1))

    def nb(dy, dx):
        return pm[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    ax, ay = gx.abs(), gy.abs() << 15
    tg22 = 13573
    horiz = (mag > nb(0, -1)) & (mag >= nb(0, 1))
    vert = (mag > nb(-1, 0)) & (mag >= nb(1, 0))
    diag_down = (mag > nb(-1, -1)) & (mag >= nb(1, 1))
    diag_up = (mag > nb(-1, 1)) & (mag >= nb(1, -1))
    sector_h = ay < tg22 * ax
    sector_v = ay > ax * (3 << 15) + tg22 * ax
    opposite = (gx ^ gy) < 0
    nms = torch.where(sector_h, horiz, torch.where(
        sector_v, vert, torch.where(opposite, diag_up, diag_down)))
    magf = mag.to(torch.float32)
    strong = nms & (magf > (high * high)[:, None, None])
    weak = nms & (magf > (low * low)[:, None, None])
    return hysteresis(strong, weak)
