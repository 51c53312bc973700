"""Seeded test images: smooth gradients, hard-edged rectangles, texture
and noise, u8-exact, made on the device in a few large calls.

Each image has a luma-like sine pattern of its own frequencies, a diagonal
ramp and a chroma cosine, six flat rectangles of random colour (the hard
edges the quadtree splits on), a texture whose amplitude falls as
1/f^1.5 over spatial frequency f (standard deviation 0.285), and Gaussian
noise of sigma 0.01.  The texture's amplitude, slope and the noise are
set so that the flagship settings (YCoCg, quality 20-80, blocks 4-128)
compress them about as much, at about the PSNR, as the LIVE photographs
(6.3x at 33.08 dB, README.md): 6.12-6.31x at 32.80-33.03 dB in samples
of 16 of 42 images on an H100.  Every seed gets the same set of
frequencies, rectangle sizes and colours (evenly spaced over their
ranges), dealt to the images in an order of its own; the seed also places
the rectangles and draws the texture's phases and the noise.  So every
seed asks about the same work of the codec, and the same seed on the same
kind of device gives the same pixels.
"""

import numpy as np
import torch

RECTS = 6
NOISE = 0.01
TEXTURE = 0.285
CHROMA = 0.5
BETA = 1.5


def _dealt(rng, lo: float, hi: float, shape) -> np.ndarray:
    """Evenly spaced values over [lo, hi), in an order drawn from rng."""
    k = int(np.prod(shape))
    grid = lo + (hi - lo) * (np.arange(k) + 0.5) / k
    return rng.permutation(grid).reshape(shape)


def synth(n: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """(n, h, w, 3) uint8 images on `device`."""
    rng = np.random.default_rng(seed)
    freq = _dealt(rng, 4, 40, (n, 3))
    dy = _dealt(rng, 8, h // 3, (n, RECTS)).astype(np.int64)
    dx = _dealt(rng, 8, w // 3, (n, RECTS)).astype(np.int64)
    colour = _dealt(rng, 0, 1, (n, RECTS, 3))
    y0 = rng.integers(0, h - 8, (n, RECTS))
    x0 = rng.integers(0, w - 8, (n, RECTS))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2 ** 62)))

    f = torch.tensor(freq, dtype=torch.float32, device=device)[:, :, None,
                                                               None]
    i = torch.arange(n, dtype=torch.float32, device=device)[:, None, None]
    y = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    x = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    img = torch.stack([
        0.5 + 0.4 * torch.sin(x / f[:, 0] + i) * torch.cos(y / f[:, 1]),
        ((x + y) / (h + w)).expand(n, h, w),
        0.5 + 0.3 * torch.cos((x - y) / f[:, 2]),
    ], -1)
    col = torch.tensor(colour, dtype=torch.float32, device=device)
    for k in range(n):
        for r in range(RECTS):
            img[k, y0[k, r]:y0[k, r] + dy[k, r],
                x0[k, r]:x0[k, r] + dx[k, r]] = col[k, r]
    img += TEXTURE * _texture(n, h, w, gen, device)
    img += NOISE * torch.randn(img.shape, generator=gen, device=device)
    return torch.round(img.clamp(0, 1) * 255).to(torch.uint8)


def _texture(n: int, h: int, w: int, gen, device) -> torch.Tensor:
    """(n, h, w, 3) texture with an amplitude spectrum of exactly 1/f^BETA,
    as natural images have, and phases drawn from `gen` (so every image
    has the same power at every frequency): a luma field in all three
    channels and fainter fields of each channel's own, each scaled to unit
    standard deviation."""
    white = torch.randn((n, 4, h, w), generator=gen, device=device)
    fy = torch.fft.fftfreq(h, device=device)[:, None]
    fx = torch.fft.rfftfreq(w, device=device)[None, :]
    f = torch.sqrt(fy * fy + fx * fx).clamp_min(1.0 / max(h, w))
    spec = torch.fft.rfft2(white)
    spec = spec / spec.abs().clamp_min(1e-12) / f ** BETA
    field = torch.fft.irfft2(spec, s=(h, w))
    field = field - field.mean((2, 3), keepdim=True)
    field = field / field.std((2, 3), keepdim=True)
    return (field[:, :1] + CHROMA * field[:, 1:]).permute(0, 2, 3, 1)


def to_host_images(u8: torch.Tensor, extension: str, image_cls):
    """uint8 images -> the codec's host images (float32 k / 255, marked
    u8-exact as its loader marks 8-bit files)."""
    lut = torch.tensor((np.arange(256) / 255.0).astype(np.float32),
                       device=u8.device)
    out = []
    for k in range(u8.shape[0]):
        data = lut[u8[k].to(torch.int64)].cpu().numpy()
        im = image_cls.from_array(data, extension=extension)
        im.u8_exact = True
        out.append(im)
    return out
