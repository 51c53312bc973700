"""Batched quadtree-active encoder: the production throughput path.

Counterpart of the JAX package's codec/batch_encode.py, with the same
dense design:

  push (host, then device): on a CUDA device, the float32 images are
      copied into a pinned per-thread buffer (by a pool of one thread a
      core for a large batch) and uploaded in one non-blocking copy; on the
      card one kernel rounds them to the unit floats of their uint8 values
      (kernels.f32_to_unit).  On the CPU and a mesh the host rounds them
      to uint8 (_host_batch), and stage A takes them to x/255.
  stage A (device): color convert, area downsample, the
      Canny stack per layer-shape GROUP of planes, pooled has-edge pyramid
      levels (bit-packed) and normalized planes padded to the block grid.
  stage B (device, queued BEFORE the host plans): for every block size s
      in the config band, DCT + quantize + zigzag of the whole padded plane
      as if uniformly tiled by s (ops/dct.py) -> dense per-size
      zigzag-int16 tables, one row per grid cell; plus a small "slow" table
      of every possible boundary (partial) block, reflect-padded like the
      reference (src/jpeg/jpeg.py:398-402).
  host (overlapped with stage B): the packed levels come to the host first,
      then the native C++ planner builds the quadtree plans.
  host: the tables come to the host in one copy; per (image, layer), C++
      assembles the preorder coefficient stream out of the dense tables and
      deflates it (native/entropy.cpp aej_layer_payload).

Output containers are .ajpg blobs in the reference format.  The host
stages need the native library (g++ and zlib at first use).
"""

import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import color, resolve_device
from ..config import CodecConfig
from ..io.container import ContainerMetadata, ContainerWriter, LayerPayload
from ..io.image import ImageData
from ..native import entropy as native_entropy
from ..ops import dct, kernels, resize
from ..ops.canny import canny
from ..utils.log import count, span, stages
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


def packed_levels(root: int, band: Tuple[int, int]) -> range:
    """The levels k of `band` that a layer of quadtree root `root` packs:
    node sizes 2**k up to the root.  Levels above the root hold no node
    ((root >> k) ** 2 = 0 bits), and the planner starts at the root; a
    root below 2**band[0] packs nothing."""
    return range(band[0], min(band[1], root.bit_length() - 1) + 1)


def _stage_a(batch: torch.Tensor, space: str,
             level_band: Optional[Tuple[int, int]], spec: BatchSpec,
             tiny: Optional[bool] = None):
    """(B, H, W, 3) uint8 or f32 -> (per-group normalized plane stacks,
    packed levels).  tiny None: a uint8 batch is taken to x/255 first, a
    float32 one as it is; tiny given: `batch` is float32 already, the unit
    floats of uint8 pixels where tiny is False (f32_to_unit's), and tiny
    says whether values under 2**-8 other than 0 may occur.

    Group planes are (B * n_l, ph, pw) float32, plane p = bi * n_l + j with
    j the layer's position within its group; the pad region is zero.
    level_band = (k_lo, k_hi): pooled has-edge masks for node sizes 2**k
    up to each layer's root (packed_levels), BIT-PACKED (one uint8 row per
    image, MSB first); None (uniform grids) skips the Canny stack."""
    if tiny is None:
        tiny = batch.dtype != torch.uint8
        if not tiny:
            batch = kernels.u8_to_unit(batch)            # exact x/255
    mids, scales = color.normalization_constants(space)
    # k/255 pixels are 0 or above 2**-8: the first contraction's flushes
    # can be skipped
    converted = color.convert("sRGB", space, batch, tiny=tiny)
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
            with span("stage_a.canny", planes=b * k, h=lh, w=lw):
                edges = canny(layer.reshape(b * k, lh, lw))
            root = qt.root_size_for(lh, lw)
            cur = torch.zeros((b * k, root, root), dtype=torch.bool,
                              device=dev)
            cur[:, :lh, :lw] = edges == 1.0
            levels = packed_levels(root, level_band)
            for lvk in range(1, levels.stop):
                cur = _pool_any(cur)
                if lvk in levels:
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
        for s in g.sizes:
            t = tables[(gi, s)]
            # (p, gh * gw, s * s) zigzag levels, plane p with layer p % n_l
            flat.append(dct.dct2_quantize(planes, s, t["hi"], t["lo"])
                        .reshape(-1))
            if "pidx" in t:
                blocks = planes[t["pidx"][:, None, None],
                                t["rows"][:, :, None], t["cols"][:, None, :]]
                # plane-major blocks, n_boundary of them per plane; the
                # reference's dot has the rows of these blocks only
                flat.append(dct.dct2_quantize(
                    blocks, s, t["hi"], t["lo"],
                    group=g.n_boundary(s)).reshape(-1))
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
    # order, the levels of the packed band up to the layer's root, (root >>
    # k)^2 bits each (the planner reads no level above the root)
    bit_offs = np.zeros((3, k_hi - k_lo + 1), np.int64)
    off = 0
    for li, root in enumerate(roots):
        for k in packed_levels(root, packed_band or band):
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
                    b: int, sparse16: bool = True):
    """Batched C++ stream assembly + entropy coding from the host dense
    tables: returns (arena, arena_offs, out_sizes); task t = (bi*3 + li)'s
    payload is arena[arena_offs[t] : arena_offs[t] + out_sizes[t]].

    shards: [(dense_np, slow_np)], one per shard of b // len(shards)
    consecutive images, each holding its images' planes in _table_layout
    order (one entry for the whole batch on a single device).  sparse16:
    the sparse coder at entropy level < 0 (native/entropy.cpp
    aej_layer_payload)."""
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
        cfg.entropy_level, arena, arena_offs, sparse16=sparse16)
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


# Batches of at least this many bytes of float32 pixels are staged by the
# copy pool; a smaller one (the preview's one 512x768 image, 4.7 MB) on the
# calling thread, where handing it to the pool would cost more than it saves.
POOL_MIN_BYTES = 8 << 20

_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _forget_pool() -> None:
    """In a forked child: the parent's pool threads do not exist there."""
    global _POOL, _POOL_LOCK
    _POOL, _POOL_LOCK = None, threading.Lock()


os.register_at_fork(after_in_child=_forget_pool)


def copy_pool() -> ThreadPoolExecutor:
    """The staging copies' pool: one thread a core the process may use,
    made at first use and shared by every caller (encode_stream's workers
    too)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(len(os.sched_getaffinity(0)),
                                       thread_name_prefix="aej-stage")
        return _POOL


def stage_images(images: Sequence[ImageData], out: np.ndarray,
                 threads: int = 1) -> None:
    """Copy each image's float32 data into out[i] of the (B, H, W, 3) `out`,
    as `threads` runs of consecutive rows of the batch on copy_pool()
    (threads 1: on the calling thread).  numpy's copy releases the GIL."""
    h = out.shape[1]
    rows = out.shape[0] * h

    def copy(lo: int, hi: int) -> None:
        while lo < hi:
            i, y = divmod(lo, h)
            n = min(hi - lo, h - y)
            np.copyto(out[i, y:y + n], images[i].data[y:y + n])
            lo += n

    if threads <= 1:
        copy(0, rows)
        return
    step = -(-rows // threads)
    pool = copy_pool()
    futs = [pool.submit(copy, lo, min(lo + step, rows))
            for lo in range(0, rows, step)]
    wait(futs)            # every run ends before the buffer is used
    for f in futs:
        f.result()


def _convert_host(images: Sequence[ImageData]) -> np.ndarray:
    """_host_batch under the push's span (the CPU device and the mesh)."""
    with span("encode.convert", cpu=True, route="host", threads=1):
        return _host_batch(images)


def _pinned_route(dev: torch.device, images: Sequence[ImageData]) -> bool:
    """True to stage float32 images in pinned memory and round them on the
    card (_push_pinned); else _host_batch rounds them on the host."""
    return dev.type == "cuda" and all(im.data.dtype == np.float32
                                      for im in images)


def _push_pinned(images: Sequence[ImageData], dev: torch.device, b: int,
                 h: int, w: int) -> torch.Tensor:
    """The images' float32 pixels, staged into this thread's pinned buffer
    (by copy_pool() for a batch of POOL_MIN_BYTES or more) and uploaded in
    one non-blocking copy: (b, h, w, 3) float32 on `dev`."""
    nbytes = b * h * w * 3 * 4
    threads = (len(os.sched_getaffinity(0)) if nbytes >= POOL_MIN_BYTES
               else 1)
    with span("encode.convert", cpu=True, route="pinned", threads=threads):
        count("push_exact_checks",
              0 if all(im.u8_exact for im in images) else 1)
        staging = pinned_buffer("enc_push", nbytes, torch.float32)
        staging = staging.reshape(b, h, w, 3)
        stage_images(images, staging.numpy(), threads)
    with span("encode.upload"):
        # the buffer is refilled only by this thread's next batch, after
        # this batch's sync.levels pull, which the stream orders after
        # this copy
        return staging.to(dev, non_blocking=True)


def _unit_batch(batch: torch.Tensor, images: Sequence[ImageData]):
    """The uploaded float32 batch -> (stage A's input, tiny): its unit
    floats (f32_to_unit, in place) when every image is exactly uint8 / 255,
    as the loader marks it or the kernel's check finds it, else the batch
    as it is (tiny True): _host_batch's choice between uint8 and float32."""
    if all(im.u8_exact for im in images):
        return kernels.f32_to_unit(batch, out=batch)[0], False
    unit, flags = kernels.f32_to_unit(batch, check=True)
    with span("sync.exact"):
        inexact = flags.cpu().numpy()
    if any(inexact[i] for i, im in enumerate(images) if not im.u8_exact):
        return batch, True
    return unit, False


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
    with span("sync.upload"):
        batch = torch.from_numpy(host).to(dev)
    if mark is not None:
        mark("push", sync=True)
    return _device_stages(batch, cfg, shape, b, mark)


def _device_stages(batch: torch.Tensor, cfg: CodecConfig, shape, b: int,
                   mark=None, tiny: Optional[bool] = None):
    """_device_shard after its upload: stage A on `batch` (as _stage_a
    takes it, with `tiny`), the packed levels' pull and stage B."""
    spec = spec_for(cfg, shape)
    tables = device_tables(cfg, shape, b, batch.device)
    group_planes, packed_bits = _stage_a(batch, cfg.color_space,
                                         level_band(cfg), spec, tiny)
    with span("sync.levels"):
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


ENCODE_STAGES = ("push", "stage_a", "plans", "device", "pull", "assemble")


def encode_batch(images: Sequence[ImageData], config: CodecConfig,
                 timings: Optional[Dict[str, float]] = None,
                 device=None, mesh=None, data_axes=None) -> List[bytes]:
    """Encode same-shape images as one device pipeline; returns .ajpg blobs
    in input order.

    device: None means CUDA (raises when CUDA is absent); pass "cpu" for
    the plain PyTorch path.  `timings` collects per-stage wall seconds:
    'push' (the images' staging on the host and their upload), 'stage_a'
    (on the card the rounding kernel, then device stage A up to the
    packed levels on the host), 'plans' (host quadtree planning, overlapped
    with device stage B), 'device' (residual stage B wait), 'pull' (tables
    to the host), 'assemble' (C++ stream assembly + deflate).  Traced
    (utils/log.py), each stage is also a span `encode.<stage>` that ends at
    the same point; the syncs of 'push' and 'device' are made only for
    `timings`.

    With `mesh` (parallel.make_mesh) instead of `device`, the push and the
    device stages run data-parallel over the mesh's `data_axes` (default:
    every axis), whole images per shard on the shard's device
    (parallel/batch.py sharded_dense_device_fn); 'stage_a' then includes
    the push.  len(images) must divide evenly.  The containers
    are byte-identical to the single-device path's."""
    return _encode(images, config, timings, device, mesh, data_axes)


def _encode(images: Sequence[ImageData], config: CodecConfig,
            timings: Optional[Dict[str, float]] = None, device=None,
            mesh=None, data_axes=None, sparse16: bool = True) -> List[bytes]:
    """encode_batch, with the sparse coder of entropy level < 0 to choose:
    the coefficient-domain one (sparse16, encode_batch's bytes) or the
    byte-level one (the per-image Codec's bytes, pipeline.py).  At level 0
    and above the flag changes nothing."""
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
    spans = stages("encode", ENCODE_STAGES if mesh is None
                   else ENCODE_STAGES[1:])

    def mark(name, sync=False):
        if timings is not None:
            if sync:
                for d in devices:
                    if d.type == "cuda":
                        torch.cuda.synchronize(d)
            marks.append(time.perf_counter())
            timings[name] = timings.get(name, 0.0) + marks[-1] - marks[-2]
        spans.mark(name)

    with spans:
        layer_shapes = cfg.layer_shapes((h, w))
        spec = spec_for(cfg, (h, w))
        if mesh is not None:
            levels, flats = device_fn(_convert_host(images))
            devices.extend({t.device for t in flats})
            mark("stage_a")
        else:
            devices.append(dev)
            if _pinned_route(dev, images):
                batch = _push_pinned(images, dev, b, h, w)
                mark("push", sync=True)
                batch, tiny = _unit_batch(batch, images)
                levels, flat = _device_stages(batch, cfg, (h, w), b, mark,
                                              tiny)
            else:
                levels, flat = _device_shard(_convert_host(images), cfg,
                                             (h, w), b, dev, mark)
            levels, flats = [levels], [flat]
        # stage B has no plan dependence: it runs while the host plans
        plans = _build_plans(cfg, layer_shapes, np.concatenate(levels),
                             level_band(cfg), b)
        mark("plans")
        mark("device", sync=True)

        b_loc = b // len(flats)
        shards = [carve_tables(to_host(t, f"enc_tables_{k}"), spec, b_loc)
                  for k, t in enumerate(flats)]
        mark("pull")

        with span("assemble.native"):
            arena, arena_offs, out_sizes = assemble_native(
                cfg, spec, plans, shards, b, sparse16)
        with span("assemble.containers"):
            out = _containers(images, cfg, h, w, plans, arena, arena_offs,
                              out_sizes)
        mark("assemble")
    return out


def _containers(images, cfg: CodecConfig, h: int, w: int, plans, arena,
                arena_offs, out_sizes) -> List[bytes]:
    """The .ajpg blobs of encode_batch's plans and assembled payloads."""
    mn, mx = cfg.block_size_range
    out = []
    for bi in range(len(images)):
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
    return out
