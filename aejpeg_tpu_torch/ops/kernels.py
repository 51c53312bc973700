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

and one kernel source of the port's own, which has no Pallas counterpart
(the reference's einsums summed in XLA's CPU order, ops/xla_dot.py), with
two entry points:

  banded_resize       <- the dense resize's two einsums (ops/resize.py)
                         csrc/banded_resize.cu
  dct_pass            <- the DCT's einsums (ops/dct.py), with stage B's
                         quantize or stage D's sum and denormalize as
                         epilogues: csrc/banded_resize.cu

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
from .libm import (_F32_MIDPOINT, _F32_MIDPOINT_MASK, _round_to_odd,
                   _two_sum, fma32_exact, fma32_sum, ftz)
from .rounding import fma32
from .zigzag import inverse_zigzag_indices, zigzag_indices


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
            "banded_resize": LaunchCounter(),
            "dct_pass": LaunchCounter()}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "aej_histogram256": ("histogram256.cu", [_VP, _VP, _LL, _LL, _VP]),
    "aej_clahe_gather": ("clahe_apply.cu",
                         [_VP] * 9 + [_I] * 5 + [_VP]),
    "aej_clahe_lut_apply": ("clahe_apply.cu", [_VP] * 6 + [_I] * 5 + [_VP]),
    "aej_u8_to_unit": ("u8_to_unit.cu", [_VP, _VP, _VP, _LL, _VP]),
    "aej_banded_resize": ("banded_resize.cu", [_VP] * 8 + [_I] * 11 + [_VP]),
    "aej_dct_pass": ("banded_resize.cu",
                     [_VP] * 4 + [_I] * 7 + [_VP, _VP, _I, _I, _VP, _I]
                     + [_VP] * 3 + [_I, _I, _VP]),
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it, starting on a 16-byte boundary (the kernels'
    vector loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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


# ------------------------------------------- XLA-ordered contractions
#
# Both entry points sum a contraction along axis 1 or 2 of a (P, H, W)
# float32 tensor in the order XLA's CPU dot sums the reference's einsum
# (ops/xla_dot.py): per k-block, `lanes` FMA chains from zero (each FMA
# rounds once) added as a tree, the blocks added in order, then the tree
# of the tail products; flushed to zero below 2**-126 as XLA's FTZ/DAZ
# code is.  banded_resize sums a band of few taps per output (a resize);
# dct_pass a dense periodic band (the DCT, one block of s inputs per
# output), optionally quantizing its results.


def _lane_tree(v):
    """XLA's sum of its per-lane partial sums: a, a + b, (a + b) + (c + d);
    each sum flushed (results below 2**-126 are zero under XLA's FTZ)."""
    if len(v) == 1:
        return v[0]
    if len(v) == 2:
        return ftz(v[0] + v[1])
    return ftz(ftz(v[0] + v[1]) + ftz(v[2] + v[3]))


def _tree_by(v, lanes_of):
    """_lane_tree of the first lanes_of[o] entries of v, per output: v a
    list of `lanes` tensors, lanes_of broadcastable against them."""
    out = v[0]
    if len(v) >= 2:
        out = torch.where(lanes_of >= 2, ftz(v[0] + v[1]), out)
    if len(v) == 4:
        out = torch.where(lanes_of >= 4, _lane_tree(v), out)
    return out


def _band_table(x, band, axis, t):
    """banded_resize_plain's sums through table t of the band, for every
    output and dot row, before the fixes of zero and non-finite results;
    also the count of infinite taps per output."""
    idx = band.idx[t].long()
    weight = band.weight[t]
    valid = idx >= 0
    view = (1, -1, 1) if axis == 1 else (1, 1, -1)
    lanes_of = band.lanes_of[t].view(view)
    infs = 0

    def tap(slot):
        nonlocal infs
        xs = x.index_select(axis, idx[slot].clamp(min=0))
        ok = valid[slot].view(view)
        infs = infs + (ok & torch.isinf(xs))
        return xs, weight[slot].view(view), ok

    lanes, steps = band.lanes, band.steps
    width = lanes * steps + lanes
    out, tails, has_tail = None, None, None
    for j in range(band.blocks):
        base = j * width
        chains = []
        for c in range(lanes):
            acc = torch.zeros((), dtype=x.dtype, device=x.device)
            for s in range(steps):
                if not bool(valid[base + c * steps + s].any()):
                    continue
                xs, w, ok = tap(base + c * steps + s)
                acc = torch.where(ok, ftz(fma32_exact(xs, w, acc)), acc)
            chains.append(acc)
        blk = _tree_by(chains, lanes_of)
        if out is None:
            out = blk
        else:
            used = valid[base:base + lanes * steps].any(0).view(view)
            out = torch.where(used, ftz(out + blk), out)
        tail_ok = valid[base + lanes * steps:base + width]
        if bool(tail_ok.any()):
            terms = []
            for c in range(lanes):
                xs, w, ok = tap(base + lanes * steps + c)
                terms.append(torch.where(ok, ftz(xs * w), 0.0))
            has = tail_ok.any(0).view(view)
            tree = _tree_by(terms, lanes_of)
            tails = tree if tails is None else torch.where(has, tree, tails)
            has_tail = has if has_tail is None else has_tail | has
    if tails is not None:
        out = torch.where(has_tail, ftz(out + tails), out)
    return out, infs


def _zero_sign(x, out, band, axis, t):
    """+0 where XLA's dot gives +0 but the band's sum is -0: XLA runs every
    k of every partial sum, and a term x * 0 with x >= +0 turns a -0 sum
    into +0.  A -0 stays only where every partial sum of every k-block
    holds a tap (`complete`) and every input past the last tap of each
    partial sum is negative (`trail`)."""
    neg0 = (out == 0) & torch.signbit(out)
    if not bool(neg0.any()):
        return out
    view = (1, -1, 1) if axis == 1 else (1, 1, -1)
    keep = band.complete[t].bool().view(view) & neg0
    trail = band.trail[t].long()            # (blocks * lanes, period)
    kblk = band.k_block[t].long()
    lanes_of = band.lanes_of[t].long()
    k = torch.arange(band.src, device=x.device)
    clear = ~torch.signbit(x)               # inputs that turn -0 into +0
    for row in range(trail.shape[0]):
        st = trail[row]
        lo = torch.where(st >= 0, st // kblk * kblk, 0)
        hi = (lo + kblk).clamp(max=band.src)
        end = lo + (hi - lo) // lanes_of * lanes_of
        mask = ((st[:, None] >= 0) & (k[None] >= st[:, None])
                & (k[None] < end[:, None])
                & ((k[None] - st[:, None]) % lanes_of[:, None] == 0))
        hits = torch.tensordot(clear.to(torch.float32),
                               mask.to(torch.float32).T,
                               dims=([axis], [0]))   # (P, W, dst) / (P, H, dst)
        if axis == 1:
            hits = hits.permute(0, 2, 1)
        keep = keep & (hits == 0)
    return torch.where(neg0 & ~keep, 0.0, out)


def banded_resize_plain(x: torch.Tensor, band, axis: int) -> torch.Tensor:
    """Plain version of banded_resize, in the kernel's order.

    Per output o: for each k-block of the band in turn, lanes_of[o] FMA
    chains from zero (each FMA rounds once, `fma32_exact`; a slot without
    a tap leaves its chain as it is) and their tree sum, the blocks added
    in order; then the tree sum of the tail products (the k past the last
    multiple of the lanes, all in the last block), added last.  A
    subnormal input reads as zero and every product and sum below 2**-126
    is flushed, as XLA's CPU code runs with FTZ and DAZ.  Dot rows from
    band.row_split on (rows: the (plane, column) pairs of axis 1, the
    (plane, row) pairs of axis 2) use table 1.  Then XLA's terms x * 0 of
    the skipped k: an output is NaN where its dot row holds a NaN, or an
    infinity at a k that is not one of its taps (its bits `_row_nan`'s);
    a -0 becomes +0 as `_zero_sign` says."""
    if band.stride:
        raise ValueError("banded_resize: the band must span the axis")
    raw = x                     # NaN bits as given (x * 0 may change them)
    x = ftz(x)
    p, h, w = x.shape
    m = p * (w if axis == 1 else h)
    out, infs = _band_table(x, band, axis, 0)
    out = _zero_sign(x, out, band, axis, 0)
    if band.row_split < m:
        out1, infs1 = _band_table(x, band, axis, 1)
        out1 = _zero_sign(x, out1, band, axis, 1)
        rows = torch.arange(m, device=x.device).view(
            (p, 1, w) if axis == 1 else (p, h, 1)) >= band.row_split
        out = torch.where(rows, out1, out)
        infs = torch.where(rows, infs1, infs)
    shape = list(x.shape)
    shape[axis] = band.period
    out = out.expand(shape)
    nans = torch.isnan(x)
    row_inf = torch.isinf(x).sum(axis, keepdim=True)
    bad = nans.any(axis, keepdim=True) | (row_inf > infs) | torch.isnan(out)
    return torch.where(bad, _row_nan(raw, nans, axis), out).contiguous()


_DEFAULT_NAN = -0x400000    # 0xffc00000: x86's NaN of inf * 0, inf - inf


def _row_nan(x, nans, axis):
    """The NaN that XLA's dot gives a row: the row's first NaN input,
    which every sum passes on, or x86's default NaN (0xffc00000) where the
    NaN comes from inf * 0 or inf - inf.  (A row with several NaN inputs
    or with both a NaN and an infinity may take another NaN on the CPU:
    not modelled.)"""
    first = nans.to(torch.uint8).argmax(axis, keepdim=True)
    bits = torch.gather(x, axis, first).view(torch.int32)
    default = torch.tensor(_DEFAULT_NAN, dtype=torch.int32, device=x.device)
    bits = torch.where(nans.any(axis, keepdim=True), bits, default)
    return bits.view(torch.float32)


def _banded_args(band):
    return (band.idx.data_ptr(), band.weight.data_ptr(),
            band.lanes_of.data_ptr(), band.k_block.data_ptr(),
            band.complete.data_ptr(), band.trail.data_ptr())


def banded_resize(x: torch.Tensor, band, axis: int) -> torch.Tensor:
    """Resize axis 1 (rows) or 2 (columns) of a contiguous (P, H, W)
    float32 tensor through `band` (ops/xla_dot.make_band), bit for bit
    with the reference's einsum as XLA's CPU dot sums it."""
    if axis not in (1, 2):
        raise ValueError(f"banded_resize: axis must be 1 or 2, got {axis}")
    _check("banded_resize", x, torch.float32, x.shape, x.device)
    if band.idx.device != x.device:
        raise ValueError(f"banded_resize: band on {band.idx.device}, "
                         f"tensor on {x.device}")
    if x.shape[axis] != band.src:
        raise ValueError(f"banded_resize: axis {axis} has {x.shape[axis]} "
                         f"inputs, the band {band.src}")
    if not _route("banded_resize", x.device):
        return banded_resize_plain(x, band, axis)
    x = _aligned(x)
    if band.stride or band.lanes not in (1, 2, 4) or x.numel() >= 2 ** 31:
        raise ValueError("banded_resize: a band spanning the axis, 1, 2 or "
                         "4 lanes, under 2**31 elements")
    p, h, w = x.shape
    dst = band.period
    out = torch.empty((p, dst, w) if axis == 1 else (p, h, dst),
                      dtype=torch.float32, device=x.device)
    if out.numel() >= 2 ** 31:
        raise ValueError("banded_resize: under 2**31 outputs")
    if out.numel():
        _launch("aej_banded_resize", x.device, x.data_ptr(), out.data_ptr(),
                *_banded_args(band), p, h, w, dst, axis, band.blocks,
                band.lanes, band.steps, band.slots, band.row_split,
                band.small_weight)
        LAUNCHES["banded_resize"].add()
    return out


# ---------------------------------------------------------------- DCT pass
_INT_RANGES = {torch.int16: (-32768.0, 32767.0),
               torch.int32: (-2147483648.0, 2147483647.0)}


def quantize_plain(y: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """XLA's quantize: fma(y, hi, y * lo) (the product y * lo rounded and
    flushed, the FMA rounding once), rounded half to even, converted to
    `dtype` with saturation (NaN -> 0), as its convert does."""
    t = fma32_sum(y.to(torch.float64) * hi.to(torch.float64),
                  ftz(y * lo))
    r = torch.round(t)
    lo_v, hi_v = _INT_RANGES[dtype]
    out = r.clamp(min=lo_v).to(torch.float64).clamp(max=hi_v).to(dtype)
    return torch.where(torch.isnan(r), 0, out).to(dtype)


def _dense_weights(band) -> torch.Tensor:
    """(period, src) weight matrix of a dense band, in k order."""
    lanes = band.dense_lanes()
    if lanes is None:
        raise ValueError("dct_pass: the band is not dense")
    s, steps = band.period, band.steps
    slot = torch.arange(steps * lanes, device=band.weight.device)
    k = slot % steps * lanes + slot // steps       # slot c*steps+t -> k
    w = torch.empty((s, band.src), dtype=torch.float32,
                    device=band.weight.device)
    w[:, k] = band.weight[0, :steps * lanes].T
    return w


_DENSE = {}
_DENSE_LOCK = threading.Lock()


def _dense(band):
    """(lanes, (period, src) weights in k order, their transpose, whether
    a weight lies under 2**-10) of a dense band, computed once per band
    object (the bands are cached by their makers and live as long as the
    process)."""
    with _DENSE_LOCK:
        hit = _DENSE.get(id(band))
        if hit is None or hit[0] is not band:
            w = _dense_weights(band).contiguous()
            hit = _DENSE[id(band)] = (
                band, band.dense_lanes(), w, w.T.contiguous(),
                int(bool((w.abs() < 2.0 ** -10).any())))
        return hit[1:]


def dct_pass_plain(x: torch.Tensor, band, axis: int) -> torch.Tensor:
    """Plain version of dct_pass without quantize: the dense periodic
    band's sums, the taps taken as strided slices of every window at once
    (k in XLA's lane order; each FMA rounded once, as `fma32_sum`, in
    place).  The
    flushes are skipped where no input can make a tiny product or sum
    (every non-zero input at least 2**-60 in magnitude and every weight at
    least 2**-10: then every non-zero result is at least 2**-116)."""
    lanes, w, _, small_w = _dense(band)
    s, k_len = w.shape
    p, h, wd = x.shape
    xa = x.abs()
    tiny = small_w or bool(((xa != 0) & (xa < 2.0 ** -60)).any())
    fl = ftz if tiny else (lambda v: v)
    x64 = fl(x).to(torch.float64)
    w64 = w.to(torch.float64)
    if axis == 1:
        xv = x64.view(p, h // k_len, k_len, wd)
        wview = (1, 1, s, 1)
        shape = (p, h // k_len, s, wd)
    else:
        xv = x64.view(p, h, wd // k_len, k_len)
        wview = (1, 1, 1, s)
        shape = (p, h, wd // k_len, s)
    # one product buffer and one bit buffer for every step, in place
    prod = torch.empty(shape, dtype=torch.float64, device=x.device)
    bits = torch.empty(shape, dtype=torch.int64, device=x.device)
    mid = torch.empty(shape, dtype=torch.bool, device=x.device)
    chains = []
    for c in range(lanes):
        acc = torch.zeros(shape, dtype=torch.float32, device=x.device)
        for k in range(c, k_len, lanes):
            tap = xv[:, :, k:k + 1, :] if axis == 1 else xv[..., k:k + 1]
            wk = w64[:, k].view(wview)
            torch.mul(tap, wk, out=prod)            # exact in float64
            prod.add_(acc)                          # one float64 rounding
            # fma32_sum's check: a float64 sum on a float32 midpoint may
            # have been rounded there; recompute those rounded to odd
            torch.bitwise_and(prod.view(torch.int64), _F32_MIDPOINT_MASK,
                              out=bits)
            torch.eq(bits, _F32_MIDPOINT, out=mid)
            if bool(mid.any()):
                pk = torch.broadcast_to(tap * wk, shape)[mid]
                prod[mid] = _round_to_odd(*_two_sum(pk, acc[mid].double()))
            acc.copy_(prod)                         # to float32, once
            if tiny:
                acc = ftz(acc)
        chains.append(acc)
    tree = _lane_tree(chains) if tiny else _lane_tree_noflush(chains)
    return tree.reshape(p, h // k_len * s if axis == 1 else h,
                        wd if axis == 1 else wd // k_len * s)


def _lane_tree_noflush(v):
    if len(v) == 1:
        return v[0]
    if len(v) == 2:
        return v[0] + v[1]
    return (v[0] + v[1]) + (v[2] + v[3])


def _levels_plain(y, quant, s):
    """quantize_plain of dct_pass's float results y (P, H, W), laid out as
    dct_pass lays its levels."""
    hi, lo, group, zigzag, dtype = quant
    p, h, w = y.shape
    gh, gw = h // s, w // s
    layer = (torch.arange(p, device=y.device) // group) % hi.shape[0]
    hi6 = hi[layer].view(p, 1, s, 1, s)
    lo6 = lo[layer].view(p, 1, s, 1, s)
    lv = quantize_plain(y.view(p, gh, s, gw, s), hi6, lo6, dtype)
    rows = lv.permute(0, 1, 3, 2, 4).reshape(p, gh * gw, s * s)
    if not zigzag:
        return rows
    zz = torch.as_tensor(zigzag_indices(s).astype(np.int64), device=y.device)
    return rows[:, :, zz]


@functools.lru_cache(maxsize=None)
def _zigzag_positions(s: int, device: torch.device) -> torch.Tensor:
    """The zigzag position of each raster position of an s x s block."""
    return torch.as_tensor(inverse_zigzag_indices(s).astype(np.int32),
                           device=device)


def _post_plain(y, add, affine):
    """dct_pass's float epilogue: y = add + y, then fma(y, rcp, mid) per
    plane (a product where mid is 0), each rounded once and flushed."""
    if add is not None:
        y = ftz(add + y)
    if affine is not None:
        rcp, mid, group = affine
        layer = (torch.arange(y.shape[0], device=y.device) // group) \
            % rcp.shape[0]
        r = rcp[layer].view(-1, 1, 1)
        mv = mid[layer].view(-1, 1, 1)
        fused = fma32_sum(y.to(torch.float64) * r.to(torch.float64),
                          mv.expand_as(y))
        y = ftz(torch.where(mv == 0, y * r, fused))
    return y


def check_card_dense(lanes: int, s: int, numel: int) -> None:
    """What the card's dct_pass takes: a dense band of 1, 2 or 4 lanes
    whose period is a power of two of at most 128 (only then do its tiles
    hold whole windows), on under 2**31 elements.  Raises ValueError for
    anything else; the plain version takes any period."""
    if (lanes not in (1, 2, 4) or not 0 < s <= 128 or s & (s - 1)
            or numel >= 2 ** 31):
        raise ValueError(
            "dct_pass on the card: a dense band of 1, 2 or 4 lanes whose "
            "period is a power of two of at most 128, under 2**31 "
            f"elements; got {lanes} lanes, period {s}, {numel} elements")


def dct_pass(x: torch.Tensor, band, axis: int, quant=None, add=None,
             affine=None) -> torch.Tensor:
    """One pass of the DCT: the dense periodic band along axis 1 or 2 of a
    contiguous (P, H, W) float32 tensor whose axis is a whole number of
    periods, bit for bit with the reference's einsum as XLA's CPU dot sums
    it -> (P, H, W) float32.

    On the second pass (axis 2) an epilogue may follow, as XLA fuses it:
    - quant=(hi, lo, group, zigzag, dtype) quantizes the results instead,
      as XLA's quantize does (quantize_plain), plane p with tables
      hi[(p // group) % L], lo[...] of (L, s, s): -> (P, gh * gw, s * s)
      levels of `dtype` (int16 or int32), one row per block in raster
      order, each row in zigzag order if `zigzag`;
    - add, a (P, H, W) float32 tensor, is added to the results (add + y),
      then affine=(rcp, mid, group) of (L,) float32 maps plane p's results
      to fma(y, rcp[l], mid[l]), l = (p // group) % L (y * rcp[l] where
      mid[l] is 0): the decoder's canvas sum and denormalize."""
    if axis not in (1, 2):
        raise ValueError(f"dct_pass: axis must be 1 or 2, got {axis}")
    _check("dct_pass", x, torch.float32, x.shape, x.device)
    if x.dim() != 3 or x.shape[axis] % band.period:
        raise ValueError("dct_pass: expected (P, H, W) with whole periods")
    epilogue = quant is not None or add is not None or affine is not None
    if epilogue and (axis != 2 or x.shape[1] % band.period):
        raise ValueError("dct_pass: an epilogue on the second pass of whole "
                         "blocks only")
    if quant is not None and (add is not None or affine is not None):
        raise ValueError("dct_pass: quantize or the float epilogue")
    if add is not None:
        _check("dct_pass", add, torch.float32, x.shape, x.device)
    s = band.period
    if not _route("dct_pass", x.device):
        y = dct_pass_plain(x, band, axis)
        if quant is not None:
            return _levels_plain(y, quant, s)
        return _post_plain(y, add, affine)
    x = _aligned(x)
    add = None if add is None else _aligned(add)
    lanes, w, w_t, small_w = _dense(band)
    check_card_dense(lanes, s, x.numel())
    p, h, wd = x.shape
    q_args = (0, 0, 1, 1, 0, 0)
    f_args = (0, 0, 0, 1, 1)
    if quant is None:
        out = torch.empty_like(x)
        if add is not None or affine is not None:
            rcp, mid, group = affine if affine is not None else (None, None,
                                                                 1)
            if rcp is not None:
                for t in (rcp, mid):
                    _check("dct_pass", t, torch.float32, (rcp.shape[0],),
                           x.device)
            f_args = (0 if add is None else add.data_ptr(),
                      0 if rcp is None else rcp.data_ptr(),
                      0 if mid is None else mid.data_ptr(), int(group),
                      1 if rcp is None else rcp.shape[0])
    else:
        hi, lo, group, zigzag, dtype = quant
        for t in (hi, lo):
            _check("dct_pass", t, torch.float32, (t.shape[0], s, s),
                   x.device)
        out = torch.empty((p, (h // s) * (wd // s), s * s), dtype=dtype,
                          device=x.device)
        perm = _zigzag_positions(s, x.device).data_ptr() if zigzag else 0
        q_args = (hi.data_ptr(), lo.data_ptr(), int(group), hi.shape[0],
                  perm, 2 if dtype == torch.int32 else 1)
    if x.numel():
        _launch("aej_dct_pass", x.device, x.data_ptr(), out.data_ptr(),
                w.data_ptr(), w_t.data_ptr(), p, h, wd, s, axis, lanes,
                small_w, *q_args, *f_args)
        LAUNCHES["dct_pass"].add()
    return out
