"""Batched quadtree-active encoder: the production throughput path.

Counterpart of the JAX package's codec/batch_encode.py, with the same
dense design:

  stage A (device): u8 -> f32 x/255, color convert, area downsample, the
      Canny stack per layer-shape GROUP of planes, pooled has-edge pyramid
      levels (bit-packed) and normalized planes padded to the block grid.
  stage B (device, queued BEFORE the host plans): for every block size s
      in the config band, DCT + quantize + zigzag of the whole padded plane
      as if uniformly tiled by s (ops/dct.py: the same contraction as the
      per-image Codec's) -> dense per-size zigzag-int16 tables, one
      row per grid cell; plus a small "slow" table of every possible
      boundary (partial) block, reflect-padded like the reference
      (src/jpeg/jpeg.py:398-402).
  host (overlapped with stage B): the packed levels come to the host first,
      then the native C++ planner builds the quadtree plans.
  host: the tables come to the host in one copy; per (image, layer), C++
      assembles the preorder coefficient stream out of the dense tables and
      deflates it (native/entropy.cpp aej_layer_payload).

Output containers are .ajpg blobs in the reference format.  The host
stages need the native library (g++ and zlib at first use).
"""

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import color, resolve_device
from ..config import CodecConfig
from ..io.container import ContainerMetadata, ContainerWriter, LayerPayload
from ..io.image import ImageData
from ..native import entropy as native_entropy
from ..ops import dct, kernels, quant, resize
from ..ops.canny import canny
from . import quadtree as qt
from .dense import BatchSpec
from .tables import device_tables, spec_for

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def require_native() -> None:
    if not native_entropy.native_available():
        raise RuntimeError(
            "the native entropy library (native/entropy.cpp) is not "
            "available: it is built at first use and needs g++ and zlib.h")


def _pool_any(mask: torch.Tensor) -> torch.Tensor:
    """(N, h, w) bool -> (N, h/2, w/2): any over each 2x2 cell."""
    n, h, w = mask.shape
    return mask.reshape(n, h // 2, 2, w // 2, 2).any(dim=4).any(dim=2)


def _stage_a(batch: torch.Tensor, space: str,
             level_band: Optional[Tuple[int, int]], spec: BatchSpec):
    """(B, H, W, 3) uint8 or f32 -> (per-group normalized plane stacks,
    packed levels).

    Group planes are (B * n_l, ph, pw) float32, plane p = bi * n_l + j with
    j the layer's position within its group; the pad region is zero.
    level_band = (k_lo, k_hi): pooled has-edge masks for node sizes 2**k,
    BIT-PACKED (one uint8 row per image, MSB first); None (uniform grids)
    skips the Canny stack."""
    if batch.dtype == torch.uint8:
        batch = kernels.u8_to_unit(batch)                # exact x/255
    mids, scales = color.normalization_constants(space)
    converted = color.convert("sRGB", space, batch)
    b = batch.shape[0]
    dev = batch.device

    packed: List = [[] for _ in range(3)]
    group_planes = []
    for g in spec.groups:
        lh, lw = g.shape
        idxs = list(g.layers)
        k = g.n_l
        # a group's layers (both chroma layers under 4:2:0) ride ONE
        # stacked resize + Canny + pyramid chain; every op is per pixel
        src = torch.stack([converted[..., i] for i in idxs], dim=1)
        layer = resize.resize2d(src, (lh, lw), "area")       # (b, k, lh, lw)
        if level_band is not None:
            edges = canny(layer.reshape(b * k, lh, lw))
            root = qt.root_size_for(lh, lw)
            cur = torch.zeros((b * k, root, root), dtype=torch.bool,
                              device=dev)
            cur[:, :lh, :lw] = edges == 1.0
            for lvk in range(1, level_band[1] + 1):
                cur = _pool_any(cur)
                if lvk >= level_band[0]:
                    lv = cur.reshape(b, k, -1)
                    for j, i in enumerate(idxs):
                        packed[i].append(lv[:, j])
        mid = torch.as_tensor(np.asarray([mids[i] for i in idxs], np.float32),
                              device=dev).reshape(1, k, 1, 1)
        scale = torch.as_tensor(
            np.asarray([scales[i] for i in idxs], np.float32),
            device=dev).reshape(1, k, 1, 1)
        norm = (layer - mid) * scale
        padded = F.pad(norm, (0, g.pw - lw, 0, g.ph - lh))
        group_planes.append(padded.reshape(b * k, g.ph, g.pw))

    flat = [lv for i in range(3) for lv in packed[i]]
    if flat:
        bits = torch.cat(flat, dim=1).to(torch.uint8)
        bits = F.pad(bits, (0, (-bits.shape[1]) % 8))
        w8 = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=dev)
        packed_bits = (bits.reshape(b, -1, 8) * w8).sum(
            dim=-1, dtype=torch.int32).to(torch.uint8)
    else:
        packed_bits = torch.zeros((b, 0), dtype=torch.uint8, device=dev)
    return group_planes, packed_bits


# --------------------------------------------------------------- stage B


def _stage_b(group_planes, spec: BatchSpec, tables, b: int) -> torch.Tensor:
    """Dense and slow zigzag-int16 tables of every (group, size), flattened
    and concatenated into ONE device tensor (one copy to the host) in the
    order _table_layout describes."""
    flat = []
    for gi, g in enumerate(spec.groups):
        planes = group_planes[gi]
        p, ph, pw = planes.shape
        n_l = g.n_l
        for s in g.sizes:
            t = tables[(gi, s)]
            gh, gw = ph // s, pw // s
            y = dct.dct2(dct.plane_blocks(planes, s))  # (p, gh, gw, s, s)
            y = y.reshape(b, n_l, gh * gw, s, s)
            hi = t["hi"].reshape(1, n_l, 1, s, s)
            lo = t["lo"].reshape(1, n_l, 1, s, s)
            lv = quant.quantize(y, hi, lo).to(torch.int16)
            rows = lv.reshape(p, gh * gw, s * s)
            flat.append(rows[:, :, t["zz"]].reshape(-1))
            if "pidx" in t:
                blocks = planes[t["pidx"][:, None, None],
                                t["rows"][:, :, None], t["cols"][:, None, :]]
                yb = dct.dct2(blocks)
                lvb = quant.quantize(yb, t["hi_rows"], t["lo_rows"])
                flat.append(lvb.to(torch.int16).reshape(-1, s * s)[:, t["zz"]]
                            .reshape(-1))
    return torch.cat(flat)


def _table_layout(spec: BatchSpec, b: int):
    """[(gi, si, 'dense'|'slow', shape)] in _stage_b's concatenation
    order."""
    out = []
    for gi, g in enumerate(spec.groups):
        p = b * g.n_l
        for si, s in enumerate(g.sizes):
            gh, gw = g.ph // s, g.pw // s
            out.append((gi, si, "dense", (p, gh * gw, s * s)))
            nb = g.n_boundary(s)
            if nb:
                out.append((gi, si, "slow", (p * nb, s * s)))
    return out


_PINNED = threading.local()


def pinned_buffer(key: str, nbytes: int, dtype: torch.dtype) -> torch.Tensor:
    """Grow-only per-thread pinned host buffer (uninitialized).  Valid until
    the same thread asks for the same key again."""
    store = getattr(_PINNED, "bufs", None)
    if store is None:
        store = _PINNED.bufs = {}
    buf = store.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 16), dtype=torch.uint8,
                          pin_memory=True)
        store[key] = buf
    return buf[:nbytes].view(dtype)


def to_host(t: torch.Tensor, key: str) -> np.ndarray:
    """Copy a device tensor to host memory (pinned per-thread scratch for
    CUDA, volatile as pinned_buffer) and return it as numpy."""
    if t.device.type == "cpu":
        return t.numpy()
    host = pinned_buffer(key, t.numel() * t.element_size(), t.dtype)
    host.copy_(t)
    return host.numpy()


# ---------------------------------------------------------------- host plan


def _build_plans(cfg: CodecConfig, layer_shapes, levels_bits: np.ndarray,
                 band: Optional[Tuple[int, int]], b: int,
                 packed_band: Optional[Tuple[int, int]] = None):
    """Quadtree plans per (image, layer) from the bit-packed pooled levels:
    one batched C++ call plans all B x 3 layers.  `packed_band` is the
    level band _stage_a packed (default: `band`); it must cover `band`."""
    mn, mx = cfg.block_size_range
    if band is None:
        return [[qt.uniform_plan(lh, lw, mn) for (lh, lw) in layer_shapes]
                for _ in range(b)]
    k_lo, k_hi = band
    roots = [qt.root_size_for(lh, lw) for (lh, lw) in layer_shapes]
    # bit offset of each (layer, level) in _stage_a's packed row: layers in
    # order, levels of the packed band, (root >> k)^2 bits each
    p_lo, p_hi = packed_band or band
    bit_offs = np.zeros((3, k_hi - k_lo + 1), np.int64)
    off = 0
    for li, root in enumerate(roots):
        for k in range(p_lo, p_hi + 1):
            if k_lo <= k <= k_hi:
                bit_offs[li, k - k_lo] = off
            off += (root >> k) ** 2
    res = native_entropy.build_plans_batch(
        levels_bits, roots, [s[0] for s in layer_shapes],
        [s[1] for s in layer_shapes], bit_offs, k_lo, k_hi, mx, mn)
    if res is None:
        raise RuntimeError("native quadtree planning failed")
    states_p, bits_len, sizes_a, ys_a, xs_a, n_leaves, _ = res
    # the arenas are volatile per-thread scratch: compact the used prefixes
    # into ONE exact-size allocation per array
    n_tasks = 3 * b
    offs = np.zeros(n_tasks + 1, np.int64)
    np.cumsum(n_leaves, out=offs[1:])
    tot = int(offs[-1])
    all_s = np.empty(tot, np.int32)
    all_y = np.empty(tot, np.int32)
    all_x = np.empty(tot, np.int32)
    for t in range(n_tasks):
        o, nl = int(offs[t]), int(n_leaves[t])
        all_s[o:o + nl] = sizes_a[t, :nl]
        all_y[o:o + nl] = ys_a[t, :nl]
        all_x[o:o + nl] = xs_a[t, :nl]
    plans = []
    for bi in range(b):
        row = []
        for li in range(3):
            t = bi * 3 + li
            o, nl = int(offs[t]), int(n_leaves[t])
            bl = int(bits_len[t])
            row.append(qt.QuadPlan(
                root_size=roots[li], height=layer_shapes[li][0],
                width=layer_shapes[li][1], states=None,
                leaf_sizes=all_s[o:o + nl], leaf_y=all_y[o:o + nl],
                leaf_x=all_x[o:o + nl],
                states_packed=states_p[t, :(bl + 7) // 8].tobytes(),
                bits_len=bl))
        plans.append(row)
    return plans


def assemble_native(cfg: CodecConfig, spec: BatchSpec, plans, shards,
                    b: int):
    """Batched C++ stream assembly + entropy coding from the host dense
    tables: returns (arena, arena_offs, out_sizes); task t = (bi*3 + li)'s
    payload is arena[arena_offs[t] : arena_offs[t] + out_sizes[t]].

    shards: [(dense_np, slow_np)], one per shard of b // len(shards)
    consecutive images, each holding its images' planes in _table_layout
    order (one entry for the whole batch on a single device)."""
    n_tasks = 3 * b
    b_loc = b // len(shards)
    lp_s = np.empty(n_tasks, np.uint64)
    lp_y = np.empty(n_tasks, np.uint64)
    lp_x = np.empty(n_tasks, np.uint64)
    n_leaves = np.empty(n_tasks, np.int64)
    hs = np.empty(n_tasks, np.int32)
    ws = np.empty(n_tasks, np.int32)
    pws = np.empty(n_tasks, np.int32)
    tbl = np.zeros((n_tasks, 8), np.uint64)
    slw = np.zeros((n_tasks, 8), np.uint64)
    totals = np.empty(n_tasks, np.int64)
    keep = []   # keep contiguous leaf arrays alive through the call
    for bi in range(b):
        for li in range(3):
            t = bi * 3 + li
            gi, j = spec.layer_pos[li]
            g = spec.groups[gi]
            plan = plans[bi][li]
            dense_np, slow_np = shards[bi // b_loc]
            plane = (bi % b_loc) * g.n_l + j
            ls = np.ascontiguousarray(plan.leaf_sizes, np.int32)
            ly = np.ascontiguousarray(plan.leaf_y, np.int32)
            lx = np.ascontiguousarray(plan.leaf_x, np.int32)
            keep.append((ls, ly, lx))
            lp_s[t] = ls.ctypes.data
            lp_y[t] = ly.ctypes.data
            lp_x[t] = lx.ctypes.data
            n_leaves[t] = len(ls)
            hs[t] = plan.height
            ws[t] = plan.width
            pws[t] = g.pw
            totals[t] = int((ls.astype(np.int64) ** 2).sum())
            for si, s in enumerate(g.sizes):
                k = s.bit_length() - 1
                arr = dense_np[gi][si]
                tbl[t, k] = (arr.ctypes.data
                             + plane * arr.shape[1] * arr.shape[2] * 2)
                nb = g.n_boundary(s)
                if nb:
                    sarr = slow_np[gi][si]
                    slw[t, k] = sarr.ctypes.data + plane * nb * s * s * 2
    lens = totals * 4
    chunks = (lens + (1 << 20) - 1) // (1 << 20) + 1
    bounds = lens + lens // 500 + 32 * chunks + 64
    arena_offs = np.zeros(n_tasks + 1, np.int64)
    np.cumsum(bounds, out=arena_offs[1:])
    # per-thread scratch: the caller copies the payloads out (.tobytes())
    arena = native_entropy.scratch_arena("assemble", int(arena_offs[-1]))
    out_sizes = native_entropy.assemble_batch_native(
        lp_s, lp_y, lp_x, n_leaves, hs, ws, pws, tbl, slw,
        cfg.entropy_level, arena, arena_offs)
    if out_sizes is None:
        raise RuntimeError("native stream assembly failed")
    return arena, arena_offs, out_sizes


# ------------------------------------------------------------ encode_batch


def _host_batch(images: Sequence[ImageData]) -> np.ndarray:
    """(B, H, W, 3) uint8 when every image is exactly uint8/255 (4x fewer
    bytes to the device; the device-side x/255 is exact), else float32.
    Images the loader marked u8_exact skip the round-trip check.  Converts
    one image at a time through a small buffer (no batch-sized float
    temporaries)."""
    h, w = images[0].original_shape[:2]
    u8 = np.empty((len(images), h, w, 3), np.uint8)
    tmp = np.empty((h, w, 3), np.float32)
    exact = True
    for i, im in enumerate(images):
        np.rint(np.multiply(im.data, np.float32(255.0), out=tmp), out=tmp)
        u8[i] = tmp
        if exact and not im.u8_exact:
            exact = np.array_equal(u8[i].astype(np.float32) / 255.0, im.data)
    return u8 if exact else np.stack([im.data for im in images])


def level_band(cfg: CodecConfig) -> Optional[Tuple[int, int]]:
    """(k_lo, k_hi): the pooled level band stage A packs (node sizes
    2 * min .. max); None for a uniform grid."""
    mn, mx = cfg.block_size_range
    return None if mn == mx else (int(math.log2(mn)) + 1, int(math.log2(mx)))


def _device_shard(host: np.ndarray, cfg: CodecConfig, shape, b: int,
                  dev: torch.device, mark=None):
    """Push `host` (b images, _host_batch's layout) to `dev`, run stage A,
    pull its packed levels (waiting for stage A only) and queue stage B:
    returns (levels (b, n) uint8 on the host, the flat stage-B tables on
    `dev`, possibly still being computed).  mark(name, sync) records the
    'push' and 'stage_a' times."""
    spec = spec_for(cfg, shape)
    tables = device_tables(cfg, shape, b, dev)
    batch = torch.from_numpy(host).to(dev)
    if mark is not None:
        mark("push", sync=True)
    group_planes, packed_bits = _stage_a(batch, cfg.color_space,
                                         level_band(cfg), spec)
    levels = packed_bits.cpu().numpy()
    if mark is not None:
        mark("stage_a")
    return levels, _stage_b(group_planes, spec, tables, b)


def carve_tables(flat, spec: BatchSpec, b: int):
    """A flat table of b images (host array or device tensor) -> (dense,
    slow), views per (group, size) in _table_layout order (slow entries
    None where a layer tiles evenly)."""
    dense = [[None] * len(g.sizes) for g in spec.groups]
    slow = [[None] * len(g.sizes) for g in spec.groups]
    off = 0
    for gi, si, kind, shape in _table_layout(spec, b):
        n = int(np.prod(shape))
        (dense if kind == "dense" else slow)[gi][si] = \
            flat[off:off + n].reshape(shape)
        off += n
    return dense, slow


def encode_batch(images: Sequence[ImageData], config: CodecConfig,
                 timings: Optional[Dict[str, float]] = None,
                 device=None, mesh=None, data_axes=None) -> List[bytes]:
    """Encode same-shape images as one device pipeline; returns .ajpg blobs
    in input order.

    device: None means CUDA (raises when CUDA is absent); pass "cpu" for
    the plain PyTorch path.  `timings` collects per-stage wall seconds:
    'push' (host->device upload), 'stage_a' (device stage A up to the
    packed levels on the host), 'plans' (host quadtree planning, overlapped
    with device stage B), 'device' (residual stage B wait), 'pull' (tables
    to the host), 'assemble' (C++ stream assembly + deflate).

    With `mesh` (parallel.make_mesh) instead of `device`, the push and the
    device stages run data-parallel over the mesh's `data_axes` (default:
    every axis), whole images per shard on the shard's device
    (parallel/batch.py sharded_dense_device_fn); 'stage_a' then includes
    the push.  len(images) must divide evenly.  The containers
    are byte-identical to the single-device path's."""
    if mesh is not None and device is not None:
        raise ValueError("pass a device or a mesh, not both")
    dev = resolve_device(device) if mesh is None else None
    cfg = config
    if not images:
        return []
    require_native()
    h, w = images[0].original_shape[:2]
    for im in images:
        if im.original_shape[:2] != (h, w):
            raise ValueError("encode_batch requires same-shape images; "
                             "group by shape upstream")
    b = len(images)
    if mesh is not None:
        from ..parallel.batch import sharded_dense_device_fn
        device_fn = sharded_dense_device_fn(cfg, (h, w), b, mesh, data_axes)
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

    layer_shapes = cfg.layer_shapes((h, w))
    spec = spec_for(cfg, (h, w))
    host_batch = _host_batch(images)
    if mesh is None:
        devices.append(dev)
        levels, flat = _device_shard(host_batch, cfg, (h, w), b, dev, mark)
        levels, flats = [levels], [flat]
    else:
        levels, flats = device_fn(host_batch)
        devices.extend({t.device for t in flats})
        mark("stage_a")
    # stage B has no plan dependence: it runs while the host plans
    plans = _build_plans(cfg, layer_shapes, np.concatenate(levels),
                         level_band(cfg), b)
    mark("plans")
    mark("device", sync=True)

    b_loc = b // len(flats)
    shards = [carve_tables(to_host(t, f"enc_tables_{k}"), spec, b_loc)
              for k, t in enumerate(flats)]
    mark("pull")

    arena, arena_offs, out_sizes = assemble_native(cfg, spec, plans, shards,
                                                   b)
    mn, mx = cfg.block_size_range
    out = []
    for bi in range(b):
        writer = ContainerWriter(ContainerMetadata(
            height=h, width=w, num_layers=3, color_space=cfg.color_space,
            quality_min=cfg.quality_range[0],
            quality_max=cfg.quality_range[1],
            block_size_min=mn, block_size_max=mx,
            extension=images[bi].extension))
        for li in range(3):
            t = bi * 3 + li
            plan = plans[bi][li]
            states_bytes, bits_len = plan.packed()
            o = int(arena_offs[t])
            writer.add_layer(LayerPayload(
                bits_len, plan.root_size, states_bytes, coeffs=None,
                compressed=arena[o:o + int(out_sizes[t])].tobytes()))
        out.append(writer.tobytes())
    mark("assemble")
    return out
