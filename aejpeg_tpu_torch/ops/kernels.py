"""The codec's hand-written CUDA kernels, their plain PyTorch versions, and
their launch counters.

Counterpart of the JAX package's ops/pallas_kernels.py:

  histogram256        <- histogram256 (_hist_kernel)
                         csrc/histogram256.cu
  clahe_apply_gather  <- clahe_apply_gather (_clahe_gather_kernel)
                         csrc/clahe_apply.cu
  clahe_lut_apply     <- clahe_lut_apply (_lut_apply_kernel)
                         csrc/clahe_apply.cu
  u8_to_unit          <- u8_to_unit_lut (_u8_lut_2d, _u8_lut_kernel)
                         csrc/u8_to_unit.cu

and one kernel of the port's own, which has no Pallas counterpart:

  banded_resize       <- the dense resize's two einsums (ops/resize.py),
                         summed in XLA's CPU order: csrc/banded_resize.cu

Each wrapper checks dtype, shape, contiguity and device.  Given CPU tensors
it runs the plain version; given CUDA tensors it launches the kernel on the
current stream (and counts the launch) or raises.  The kernels are built
at first use (ops/_build.py).
"""

import ctypes
import functools
import threading
from typing import Sequence

import numpy as np
import torch

from . import _build
from .libm import fma32_exact, ftz
from .rounding import fma32


class LaunchCounter:
    """Thread-safe count of a kernel's launches (the stream pipeline
    launches from worker threads)."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def n(self) -> int:
        return self._n


LAUNCHES = {"histogram256": LaunchCounter(),
            "clahe_apply_gather": LaunchCounter(),
            "clahe_lut_apply": LaunchCounter(),
            "u8_to_unit": LaunchCounter(),
            "banded_resize": LaunchCounter()}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "aej_histogram256": ("histogram256.cu", [_VP, _VP, _LL, _LL, _VP]),
    "aej_clahe_gather": ("clahe_apply.cu",
                         [_VP] * 9 + [_I] * 5 + [_VP]),
    "aej_clahe_lut_apply": ("clahe_apply.cu", [_VP] * 6 + [_I] * 5 + [_VP]),
    "aej_u8_to_unit": ("u8_to_unit.cu", [_VP, _VP, _VP, _LL, _VP]),
    "aej_banded_resize": ("banded_resize.cu",
                          [_VP, _VP, _VP, _VP] + [_I] * 9 + [_VP]),
}
_FNS = {}
_FNS_LOCK = threading.Lock()


def _fn(name: str):
    with _FNS_LOCK:
        fn = _FNS.get(name)
        if fn is None:
            source, argtypes = _SIGNATURES[name]
            fn = getattr(_build.library(source), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[name] = fn
        return fn


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _fn(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: Sequence[int], device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")


def _route(name: str, device: torch.device) -> bool:
    """True to launch the CUDA kernel, False for the plain version."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {device}")


# ---------------------------------------------------------------- histogram


def histogram256_plain(values: torch.Tensor) -> torch.Tensor:
    """(P, T, N) int32 -> (P, T, 256) int32 exact counts of the values in
    [0, 255] per row; anything else (the -1 padding) is not counted."""
    p, t, n = values.shape
    rows = p * t
    flat = values.reshape(rows, n).to(torch.int64)
    valid = (flat >= 0) & (flat < 256)
    base = torch.arange(rows, device=values.device).mul_(256)[:, None]
    idx = torch.where(valid, flat + base, rows * 256)   # spill bin at end
    counts = torch.zeros(rows * 256 + 1, dtype=torch.int64,
                         device=values.device)
    counts.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx).reshape(-1))
    return counts[:-1].reshape(p, t, 256).to(torch.int32)


def histogram256(values: torch.Tensor) -> torch.Tensor:
    """(P, T, N) int32 values -> (P, T, 256) int32 histograms per row."""
    if values.dim() != 3:
        raise ValueError("histogram256: expected (P, T, N) values")
    _check("histogram256", values, torch.int32, values.shape, values.device)
    if not _route("histogram256", values.device):
        return histogram256_plain(values)
    p, t, n = values.shape
    out = torch.empty((p, t, 256), dtype=torch.int32, device=values.device)
    _launch("aej_histogram256", values.device, values.data_ptr(),
            out.data_ptr(), p * t, n)
    LAUNCHES["histogram256"].add()
    return out


# -------------------------------------------------------- CLAHE LUT gather


def clahe_gather_supported(h: int, w: int, th: int, gh: int, gw: int) -> bool:
    """Same gate as the JAX package: 4 packable tile columns and an even
    tile height whose half is a multiple of 8 (the half-tile band)."""
    return gw == 4 and th % 2 == 0 and (th // 2) % 8 == 0


def clahe_apply_gather_plain(img, words, ix0, ix1, xa, xa1, ya, ya1,
                             th: int) -> torch.Tensor:
    """Plain version of clahe_apply_gather (same arguments); widens the
    uint8 pixels itself."""
    p, h, w = img.shape
    gh = words.shape[1]
    k = torch.arange(h, device=img.device) // (th // 2)
    top = torch.clamp(k - 1, min=0) // 2
    bot = torch.clamp((k + 1) // 2, max=gh - 1)
    v = img.to(torch.int64)
    wt = torch.gather(words[:, top, :], 2, v)
    wb = torch.gather(words[:, bot, :], 2, v)
    s0 = ix0 * 8
    s1 = ix1 * 8
    tl = ((wt >> s0) & 255).to(torch.float32)
    tr = ((wt >> s1) & 255).to(torch.float32)
    bl = ((wb >> s0) & 255).to(torch.float32)
    br = ((wb >> s1) & 255).to(torch.float32)
    top_row = fma32(tl, xa1, tr * xa)
    bot_row = fma32(bl, xa1, br * xa)
    return fma32(top_row, ya1[:, None], bot_row * ya[:, None])


def clahe_apply_gather(img: torch.Tensor, words: torch.Tensor,
                       ix0: torch.Tensor, ix1: torch.Tensor,
                       xa: torch.Tensor, xa1: torch.Tensor,
                       ya: torch.Tensor, ya1: torch.Tensor,
                       th: int) -> torch.Tensor:
    """(P, H, W) uint8 pixels, (P, gh, 256) int32 packed LUT
    words (byte c = tile column c), per-column (W,) int32 tile-column
    indices ix0/ix1 and f32 weights xa/xa1, per-row (H,) f32 weights
    ya/ya1, tile height th -> (P, H, W) f32 blended LUT output (before
    rounding): (TL*xa1 + TR*xa)*ya1 + (BL*xa1 + BR*xa)*ya, OpenCV's
    association, with each `a*b + c` one FMA (first product fused) as the
    JAX reference rounds it (ops/rounding.py)."""
    if img.dim() != 3 or words.dim() != 3:
        raise ValueError("clahe_apply_gather: expected (P, H, W) pixels and "
                         "(P, gh, 256) words")
    p, h, w = img.shape
    gh = words.shape[1]
    dev = img.device
    _check("clahe_apply_gather", img, torch.uint8, (p, h, w), dev)
    _check("clahe_apply_gather", words, torch.int32, (p, gh, 256), dev)
    for vec, dt, n in ((ix0, torch.int32, w), (ix1, torch.int32, w),
                       (xa, torch.float32, w), (xa1, torch.float32, w),
                       (ya, torch.float32, h), (ya1, torch.float32, h)):
        _check("clahe_apply_gather", vec, dt, (n,), dev)
    if th % 2 or th // 2 < 1 or gh < 1 or gh > 48:
        raise ValueError(f"clahe_apply_gather: bad tiling th={th} gh={gh}")
    if not _route("clahe_apply_gather", dev):
        return clahe_apply_gather_plain(img, words, ix0, ix1, xa, xa1,
                                        ya, ya1, th)
    if p > 65535:
        raise ValueError("clahe_apply_gather: at most 65535 planes a call")
    out = torch.empty((p, h, w), dtype=torch.float32, device=dev)
    _launch("aej_clahe_gather", dev, img.data_ptr(), words.data_ptr(),
            ix0.data_ptr(), ix1.data_ptr(), xa.data_ptr(), xa1.data_ptr(),
            ya.data_ptr(), ya1.data_ptr(), out.data_ptr(), p, h, w, gh, th)
    LAUNCHES["clahe_apply_gather"].add()
    return out


# -------------------------------------------------- CLAHE 4-tap fallback


def clahe_lut_apply_plain(img, lut, iy, ix, wts, gw: int) -> torch.Tensor:
    """Plain version of clahe_lut_apply (same arguments); widens the uint8
    pixels itself."""
    p, h, w = img.shape
    n_tiles = lut.shape[1]
    taps = (iy[:, None, :, None] * gw + ix[None, :, None, :]).reshape(
        h, w, 4).to(torch.int64)
    flat = lut.reshape(p, n_tiles * 256)
    v = img.to(torch.int64)
    acc = torch.zeros((p, h, w), dtype=torch.float32, device=img.device)
    for j in range(4):
        vals = torch.gather(flat, 1, (taps[:, :, j] * 256 + v).reshape(p, -1))
        acc = fma32(wts[:, :, j], vals.reshape(p, h, w), acc)
    return acc


def clahe_lut_apply(img: torch.Tensor, lut: torch.Tensor, iy: torch.Tensor,
                    ix: torch.Tensor, wts: torch.Tensor,
                    gw: int) -> torch.Tensor:
    """(P, H, W) uint8 pixels, (P, T, 256) f32 tile LUTs,
    per-row (H, 2) int32 top/bottom tile rows iy in [0, T / gw), per-column
    (W, 2) int32 left/right tile columns ix in [0, gw), (H, W, 4) f32 tap
    weights in the order
    (iy0,ix0), (iy0,ix1), (iy1,ix0), (iy1,ix1), tile-grid width gw ->
    (P, H, W) f32 = sum of the 4 taps weight * LUT[tile, pixel] (before
    rounding), accumulated in tap order as acc = fma(w, lut, acc): the
    JAX reference's sequential FMA reduction over its 16 tiles, whose 12
    zero-weight terms leave the sum unchanged (ops/rounding.py)."""
    if img.dim() != 3 or lut.dim() != 3:
        raise ValueError("clahe_lut_apply: expected (P, H, W) pixels and "
                         "(P, T, 256) LUTs")
    p, h, w = img.shape
    n_tiles = lut.shape[1]
    dev = img.device
    _check("clahe_lut_apply", img, torch.uint8, (p, h, w), dev)
    _check("clahe_lut_apply", lut, torch.float32, (p, n_tiles, 256), dev)
    _check("clahe_lut_apply", iy, torch.int32, (h, 2), dev)
    _check("clahe_lut_apply", ix, torch.int32, (w, 2), dev)
    _check("clahe_lut_apply", wts, torch.float32, (h, w, 4), dev)
    if not _route("clahe_lut_apply", dev):
        return clahe_lut_apply_plain(img, lut, iy, ix, wts, gw)
    if (p > 65535 or n_tiles > 47 or wts.data_ptr() % 16
            or lut.data_ptr() % 16 or iy.data_ptr() % 8 or ix.data_ptr() % 8):
        raise ValueError("clahe_lut_apply: at most 65535 planes a call, 47 "
                         "tiles (staged in 48 KB of shared memory), 16-byte "
                         "aligned weights and LUTs, 8-byte aligned taps")
    out = torch.empty((p, h, w), dtype=torch.float32, device=dev)
    _launch("aej_clahe_lut_apply", dev, img.data_ptr(), lut.data_ptr(),
            iy.data_ptr(), ix.data_ptr(), wts.data_ptr(), out.data_ptr(),
            p, h, w, n_tiles, gw)
    LAUNCHES["clahe_lut_apply"].add()
    return out


# ------------------------------------------------------- exact u8 -> x/255


@functools.lru_cache(maxsize=None)
def _unit_table(device: torch.device) -> torch.Tensor:
    """The 256 float32 values numpy's x.astype(np.float32) / 255 takes, as
    the JAX package's _u8_unit_table builds them, on `device`."""
    return torch.as_tensor(np.arange(256, dtype=np.float32) / 255,
                           device=device)


def u8_to_unit_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of u8_to_unit: a gather from the same table."""
    return _unit_table(x.device)[x.long()]


def u8_to_unit(x: torch.Tensor) -> torch.Tensor:
    """Contiguous uint8 tensor of any shape -> float32 x/255, bit-equal to
    numpy's x.astype(np.float32) / 255 for all 256 values."""
    _check("u8_to_unit", x, torch.uint8, x.shape, x.device)
    if not _route("u8_to_unit", x.device):
        return u8_to_unit_plain(x)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.numel():
        _launch("aej_u8_to_unit", x.device, x.data_ptr(), out.data_ptr(),
                _unit_table(x.device).data_ptr(), x.numel())
        LAUNCHES["u8_to_unit"].add()
    return out


# ------------------------------------------------------------ banded resize
def _lane_tree(v):
    """XLA's sum of its per-lane partial sums: a, a + b, (a + b) + (c + d);
    each sum flushed (results below 2**-126 are zero under XLA's FTZ)."""
    if len(v) == 1:
        return v[0]
    if len(v) == 2:
        return ftz(v[0] + v[1])
    return ftz(ftz(v[0] + v[1]) + ftz(v[2] + v[3]))


def banded_resize_plain(x: torch.Tensor, band, axis: int) -> torch.Tensor:
    """Plain version of banded_resize, in the kernel's order.

    Per output: for each k-block of the band in turn, `lanes` FMA chains
    from zero (each FMA rounds once, `fma32_exact`; a slot without a tap
    leaves its chain as it is) and their tree sum, the blocks added in
    order; then the tree sum of the tail products (the k past the last
    multiple of `lanes`, all in the last block), added last.  A subnormal
    input reads as zero and every product and sum below 2**-126 is
    flushed, as XLA's CPU code runs with FTZ and DAZ: float planes can
    hold subnormal pixels, and a product of a tiny pixel by a weight under
    1 falls below 2**-126."""
    x = ftz(x)
    idx, weight = band.idx.long(), band.weight
    valid = idx >= 0
    view = (1, -1, 1) if axis == 1 else (1, 1, -1)

    def tap(slot):
        xs = x.index_select(axis, idx[:, slot].clamp(min=0))
        return (xs, weight[:, slot].view(view), valid[:, slot].view(view))

    width = band.lanes * band.steps + band.lanes
    out = None
    tails = None
    for j in range(band.blocks):
        base = j * width
        lanes = []
        for c in range(band.lanes):
            acc = torch.zeros((), dtype=x.dtype, device=x.device)
            for s in range(band.steps):
                xs, w, ok = tap(base + c * band.steps + s)
                acc = torch.where(ok, ftz(fma32_exact(xs, w, acc)), acc)
            lanes.append(acc)
        blk = _lane_tree(lanes)
        if out is None:
            out = blk
        else:
            used = valid[:, base:base + band.lanes * band.steps].any(1)
            out = torch.where(used.view(view), ftz(out + blk), out)
        tail_ok = valid[:, base + band.lanes * band.steps:base + width]
        if bool(tail_ok.any()):
            tails = [torch.where(ok, ftz(xs * w), 0.0) for xs, w, ok in
                     (tap(base + band.lanes * band.steps + t)
                      for t in range(band.lanes))]
            has_tail = tail_ok.any(1).view(view)
    if tails is not None:
        out = torch.where(has_tail, ftz(out + _lane_tree(tails)), out)
    shape = list(x.shape)
    shape[axis] = band.idx.shape[0]
    return out.expand(shape).contiguous()


def banded_resize(x: torch.Tensor, band, axis: int) -> torch.Tensor:
    """Resize axis 1 (rows) or 2 (columns) of a contiguous (P, H, W)
    float32 tensor through `band` (ops/resize.band), bit for bit with the
    reference's einsum as XLA's CPU dot sums it."""
    if axis not in (1, 2):
        raise ValueError(f"banded_resize: axis must be 1 or 2, got {axis}")
    _check("banded_resize", x, torch.float32, x.shape, x.device)
    if band.idx.device != x.device:
        raise ValueError(f"banded_resize: band on {band.idx.device}, "
                         f"tensor on {x.device}")
    if not _route("banded_resize", x.device):
        return banded_resize_plain(x, band, axis)
    p, h, w = x.shape
    dst = band.idx.shape[0]
    out = torch.empty((p, dst, w) if axis == 1 else (p, h, dst),
                      dtype=torch.float32, device=x.device)
    if out.numel():
        _launch("aej_banded_resize", x.device, x.data_ptr(), out.data_ptr(),
                band.idx.data_ptr(), band.weight.data_ptr(), p, h, w, dst,
                axis, band.blocks, band.lanes, band.steps,
                band.idx.shape[1])
        LAUNCHES["banded_resize"].add()
    return out
