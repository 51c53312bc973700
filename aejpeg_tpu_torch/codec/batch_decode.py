"""Batched quadtree decoder: the mirror of `batch_encode`.

Counterpart of the JAX package's codec/batch_decode.py:

  host: parse containers; one batched C++ call replays every layer's state
      stream, inflates its coefficient stream and scatters each leaf's
      zigzag row, narrowed to int16, into dense per-size tables, marking
      the leaf's grid cell in a per-size mask (native/entropy.cpp
      aej_decode_batch).  Tables and masks live in per-thread host scratch
      (pinned for CUDA), one contiguous arena each, so each goes to the
      device in one copy.
  device: per size, gate non-leaf rows to zero, inverse zigzag,
      dequantize, dense inverse DCT over the whole plane; SUM the per-size
      reconstructions (leaves partition the plane); then crop, denormalize,
      bilinear-upsample chroma and invert the color transform for all
      images at once.

Requires same-shape, same-settings containers; group upstream otherwise.
"""

import ctypes
import functools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import color, resolve_device
from ..config import CodecConfig
from ..io.container import ContainerReader
from ..io.image import ImageData
from ..native import entropy as native_entropy
from ..ops import dct, quant, resize
from .batch_encode import pinned_buffer, require_native
from .dense import BatchSpec
from .tables import device_tables, spec_for


@functools.lru_cache(maxsize=None)
def denormalize_consts(space: str, layers, device: torch.device):
    """(rcp, mid) float32 tensors of the given layers: the reference's
    canvas / scale + mid is, as XLA compiles it, fma(canvas, f32(1 /
    f32(scale)), mid), or canvas * rcp where mid is 0."""
    mids, scales = color.normalization_constants(space)
    rcp = [np.float32(1.0) / np.float32(scales[i]) for i in layers]
    mid = [np.float32(mids[i]) for i in layers]
    return (torch.as_tensor(np.asarray(rcp, np.float32), device=device),
            torch.as_tensor(np.asarray(mid, np.float32), device=device))


def _stage_d(tables, masks, spec: BatchSpec, consts, cfg: CodecConfig,
             shape, b: int) -> torch.Tensor:
    """Dense decode on the device: tables[gi][si] = (B * n_l, gh * gw,
    s * s) zigzag int16, masks[gi][si] = (B * n_l, gh * gw) uint8 leaf-row
    gates -> (B, H, W, 3) float32 sRGB.  Non-leaf table rows may hold
    anything (the host fills them from uninitialized scratch); the masks
    zero them before dequantize."""
    h, w = shape
    canvases = []
    for gi, g in enumerate(spec.groups):
        ph, pw, n_l = g.ph, g.pw, g.n_l
        dev = tables[gi][0].device
        rcp, mid = denormalize_consts(cfg.color_space, tuple(g.layers), dev)
        canvas = None
        for si, s in enumerate(g.sizes):
            t = consts[(gi, s)]
            gh, gw = ph // s, pw // s
            zzrows = torch.where(masks[gi][si][:, :, None] != 0,
                                 tables[gi][si], 0)
            lv = zzrows[:, :, t["inv_zz"]].reshape(b, n_l, gh, gw, s, s)
            # dequantize into (b * n_l, ph, pw) planes, blocks in place
            coeffs = torch.empty((b * n_l, ph, pw), dtype=torch.float32,
                                 device=dev)
            coeffs.view(b, n_l, gh, s, gw, s).permute(0, 1, 2, 4, 3, 5) \
                .copy_(quant.dequantize(lv, t["q"].reshape(1, n_l, 1, 1,
                                                           s, s)))
            # the per-size sum (the reference's canvas starts from zeros,
            # which XLA drops) and, after the last size, the denormalize,
            # as the inverse DCT's epilogue
            last = si == len(g.sizes) - 1
            canvas = dct.idct2_planes(coeffs, s, add=canvas,
                                      affine=(rcp, mid, 1) if last else None)
        canvases.append(canvas.view(b, n_l, ph, pw))

    ups = []
    for li in range(3):
        gi, j = spec.layer_pos[li]
        lh, lw = spec.groups[gi].shape
        layer = canvases[gi][:, j, :lh, :lw]
        ups.append(resize.resize2d(layer, (h, w), "linear"))
    return color.convert(cfg.color_space, "sRGB", torch.stack(ups, dim=-1),
                         tiny=False)           # decoded planes


def parse_native_into_tables(payloads, spec: BatchSpec, shards,
                             b: int) -> np.ndarray:
    """One batched C++ call: per (container, layer) replay the state
    stream, inflate the coefficient stream and scatter int16 rows into the
    caller's dense host tables/masks.  Raises on malformed containers.

    shards: [(tables, masks)], one per shard of b // len(shards)
    consecutive images, tables[gi][si] (b_loc * n_l, gh * gw, s * s) int16
    and masks[gi][si] (b_loc * n_l, gh * gw) uint8."""
    n_tasks = 3 * b
    b_loc = b // len(shards)
    st_ptrs = np.empty(n_tasks, np.uint64)
    bits_lens = np.empty(n_tasks, np.int64)
    root_sizes = np.empty(n_tasks, np.int32)
    comp_ptrs = np.empty(n_tasks, np.uint64)
    comp_lens = np.empty(n_tasks, np.int64)
    pws = np.empty(n_tasks, np.int32)
    phs = np.empty(n_tasks, np.int32)
    tbl = np.zeros((n_tasks, 8), np.uint64)
    msk = np.zeros((n_tasks, 8), np.uint64)
    keep = []   # keep the ctypes views of the payload bytes alive
    for bi in range(b):
        for li in range(3):
            t = bi * 3 + li
            payload = payloads[bi][li]
            gi, j = spec.layer_pos[li]
            g = spec.groups[gi]
            tables, masks = shards[bi // b_loc]
            plane = (bi % b_loc) * g.n_l + j
            sb = ctypes.c_char_p(payload.states_bytes)
            cb = ctypes.c_char_p(payload.compressed)
            keep.append((sb, cb))
            st_ptrs[t] = ctypes.cast(sb, ctypes.c_void_p).value or 0
            comp_ptrs[t] = ctypes.cast(cb, ctypes.c_void_p).value or 0
            bits_lens[t] = payload.bits_len
            root_sizes[t] = payload.root_size
            comp_lens[t] = len(payload.compressed)
            pws[t] = g.pw
            phs[t] = g.ph
            for si, s in enumerate(g.sizes):
                k = s.bit_length() - 1
                arr = tables[gi][si]
                tbl[t, k] = (arr.ctypes.data
                             + plane * arr.shape[1] * arr.shape[2] * 2)
                marr = masks[gi][si]
                msk[t, k] = marr.ctypes.data + plane * marr.shape[1]
    done = native_entropy.decode_batch_native(
        st_ptrs, bits_lens, root_sizes, comp_ptrs, comp_lens, pws, phs,
        tbl, msk)
    if done is None:
        raise RuntimeError("native decode is unavailable")
    if (done < 0).any():
        bad = int(np.nonzero(done < 0)[0][0])
        raise ValueError(f"malformed .ajpg container (image {bad // 3}, "
                         f"layer {bad % 3})")
    return done


def _scratch(key: str, n: int, dtype: torch.dtype, dev: torch.device
             ) -> torch.Tensor:
    """Uninitialized host scratch of n elements: pinned for CUDA uploads,
    plain per-thread numpy scratch for the CPU path."""
    if dev.type == "cuda":
        return pinned_buffer(key, n * torch.empty(0, dtype=dtype)
                             .element_size(), dtype)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return torch.from_numpy(native_entropy.scratch_view(key, (n,), np_dtype))


def _section_shapes(spec: BatchSpec, b: int):
    """[[(table shape, mask shape)] per size] per group, for b images."""
    return [[((b * g.n_l, (g.ph // s) * (g.pw // s), s * s),
              (b * g.n_l, (g.ph // s) * (g.pw // s))) for s in g.sizes]
            for g in spec.groups]


def _carve(flat, shapes, which: int):
    """A flat arena -> [[view per size] per group] of shapes[..][which]."""
    out, off = [], 0
    for per in shapes:
        views = []
        for shp in per:
            n = int(np.prod(shp[which]))
            views.append(flat[off:off + n].reshape(shp[which]))
            off += n
        out.append(views)
    return out


def host_arenas(key: str, spec: BatchSpec, b: int, dev: torch.device):
    """Host scratch for b images' tables and masks: (tables, masks) flat
    tensors, one arena each (tables uninitialized, masks zeroed: 1 byte
    per block), volatile until this thread asks for `key` again."""
    shapes = _section_shapes(spec, b)
    n_tbl = sum(int(np.prod(ts)) for per in shapes for ts, _ in per)
    n_msk = sum(int(np.prod(ms)) for per in shapes for _, ms in per)
    tbl = _scratch(f"{key}_tables", n_tbl, torch.int16, dev)
    msk = _scratch(f"{key}_masks", n_msk, torch.uint8, dev)
    msk.zero_()
    return tbl, msk


def parse_into_arenas(payloads, spec: BatchSpec, arenas, b: int) -> None:
    """parse_native_into_tables into per-shard host arenas (host_arenas of
    b // len(arenas) images each)."""
    shapes = _section_shapes(spec, b // len(arenas))
    parse_native_into_tables(
        payloads, spec, [(_carve(t.numpy(), shapes, 0),
                          _carve(m.numpy(), shapes, 1)) for t, m in arenas],
        b)


def _device_shard(tbl_host: torch.Tensor, msk_host: torch.Tensor,
                  cfg: CodecConfig, shape, b: int, dev: torch.device,
                  mark=None) -> torch.Tensor:
    """Upload one shard's arenas to `dev` (blocking: the host scratch is
    reused) and queue stage D: (b, H, W, 3) float32 sRGB on `dev`, possibly
    still being computed.  mark(name, sync) records 'push'."""
    spec = spec_for(cfg, shape)
    shapes = _section_shapes(spec, b)
    tables = _carve(tbl_host.to(dev), shapes, 0)
    masks = _carve(msk_host.to(dev), shapes, 1)
    if mark is not None:
        mark("push", sync=True)
    consts = device_tables(cfg, shape, None, dev)
    return _stage_d(tables, masks, spec, consts, cfg, shape, b)


def decode_batch(blobs: List[bytes],
                 timings: Optional[Dict[str, float]] = None,
                 device=None, materialize: bool = True, mesh=None,
                 data_axes=None):
    """Decode same-settings .ajpg blobs as one device pipeline; returns
    images in input order.

    device: None means CUDA (raises when CUDA is absent); pass "cpu" for
    the plain PyTorch path.  Stage timings: 'parse' (inflate + replay +
    dense scatter, C++), 'push', 'device', 'pull'.  materialize=False
    returns the (B, H, W, 3) float32 device tensor and the metadata list
    instead of host ImageData (no device->host image copy).

    With `mesh` (parallel.make_mesh) instead of `device`, each shard of
    whole images (over the mesh's `data_axes`, default every axis) is
    parsed into its own host arenas and decoded on its device
    (parallel/batch.py sharded_dense_decode_fn); 'device' then
    includes the push, and materialize=False gathers the shards on the
    mesh's first shard device.  len(blobs) must divide evenly."""
    if mesh is not None and device is not None:
        raise ValueError("pass a device or a mesh, not both")
    dev = resolve_device(device) if mesh is None else None
    if not blobs:
        return []
    require_native()
    marks = [time.perf_counter()]
    devices = []

    def mark(name, sync=False):
        if timings is not None:
            if sync:
                for d in devices:
                    if d.type == "cuda":
                        torch.cuda.synchronize(d)
            marks.append(time.perf_counter())
            timings[name] = timings.get(name, 0.0) + marks[-1] - marks[-2]

    readers = [ContainerReader(blob) for blob in blobs]
    metas = [r.metadata for r in readers]
    m0 = metas[0]
    key0 = (m0.height, m0.width, m0.color_space, m0.quality_min,
            m0.quality_max, m0.block_size_min, m0.block_size_max)
    for m in metas[1:]:
        if (m.height, m.width, m.color_space, m.quality_min, m.quality_max,
                m.block_size_min, m.block_size_max) != key0:
            raise ValueError("decode_batch requires same-shape, "
                             "same-settings containers")
    cfg = CodecConfig(m0.color_space, (m0.quality_min, m0.quality_max),
                      (m0.block_size_min, m0.block_size_max))
    h, w = m0.height, m0.width
    b = len(blobs)
    spec = spec_for(cfg, (h, w))
    if mesh is None:
        devices.append(dev)
        shard_devs = [dev]
    else:
        from ..parallel.batch import sharded_dense_decode_fn
        device_fn, shard_devs = sharded_dense_decode_fn(cfg, (h, w), b,
                                                        mesh, data_axes)
        devices.extend(set(shard_devs))
    b_loc = b // len(shard_devs)
    arenas = [host_arenas(f"dec_{k}", spec, b_loc, d)
              for k, d in enumerate(shard_devs)]
    payloads = [[r.read_layer_raw() for _ in range(3)] for r in readers]
    parse_into_arenas(payloads, spec, arenas, b)
    mark("parse")

    if mesh is None:
        outs = [_device_shard(*arenas[0], cfg, (h, w), b, dev, mark)]
    else:
        outs = device_fn(arenas)
    mark("device", sync=True)
    if not materialize:
        return (outs[0] if len(outs) == 1 else
                torch.cat([o.to(shard_devs[0]) for o in outs])), metas
    if all(o.device.type == "cpu" for o in outs):
        arr = (outs[0].numpy() if len(outs) == 1
               else np.concatenate([o.numpy() for o in outs]))
    else:
        host = torch.empty((b, h, w, 3), dtype=torch.float32,
                           pin_memory=True)
        for k, o in enumerate(outs):
            host[k * b_loc:(k + 1) * b_loc].copy_(o)
        arr = host.numpy()
    mark("pull")
    return [ImageData(arr[i], (h, w, 3), metas[i].extension)
            for i in range(b)]
