"""The uniform-grid device encode step and the data-parallel batch steps.

Counterpart of the JAX package's parallel/batch.py.
`device_encode_uniform` runs the whole device side of encode for one image
when block_size_min == max: color convert, chroma downsample, the Canny
edge stack, normalization, Morton-ordered block extraction, DCT,
quantization and zigzag.  A uniform grid's Morton order is the container's
preorder, so its coefficient rows are the container's coefficient stream.

`sharded_dense_device_fn` / `sharded_dense_decode_fn` split the batched
codec's device stages over a mesh's data axes, whole images per shard.
The caller's thread dispatches the shards in turn, each on its own device:
the host waits inside a shard (the Canny hysteresis syncs about 22 times
a batch) wait for that shard's device only, while the shards before it
keep running.  One host thread per shard was measured 1.9-6.8x slower on
H100s: eager dispatch from several threads hands the GIL over at every op
(tools/mesh_scaling.py).  The dense tables are plane-major (plane =
bi * n_l + j), so shard k's tables are the single-device tables' rows of
its images, and the containers and decodes are the single-device path's.
"""

import functools
from contextlib import nullcontext
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .. import color, resolve_device
from ..codec.pipeline import _canny_plane, _color_and_downsample
from ..codec.quadtree import _interleave_bits
from ..config import CodecConfig
from ..ops import dct, quant
from ..utils.mathutils import root_size_for
from .mesh import shard_devices


@functools.lru_cache(maxsize=None)
def _uniform_grid_order(h: int, w: int, s: int) -> np.ndarray:
    """Morton (preorder) order of the in-bounds s-blocks of an (h, w) layer,
    as flat raster indices into the (gh, gw) block grid."""
    g = root_size_for(h, w) // s
    bi, bj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    exists = (bi * s < h) & (bj * s < w)
    bi, bj = bi[exists], bj[exists]
    order = np.argsort(_interleave_bits(bi, bj, int(g).bit_length()),
                       kind="stable")
    return (bi[order] * -(-w // s) + bj[order]).astype(np.int64)


def _extract_uniform_blocks(layer: torch.Tensor, s: int) -> torch.Tensor:
    """(h, w) -> (n_blocks, s, s) in Morton/preorder order, partial
    boundary blocks padded by reflecting the layer (np.pad 'reflect': rows
    h-2, h-3, ..., no edge duplicate)."""
    h, w = layer.shape
    gh, gw = -(-h // s), -(-w // s)
    ph, pw = gh * s - h, gw * s - w
    if ph or pw:
        ridx = np.concatenate([np.arange(h), h - 2 - np.arange(ph)])
        cidx = np.concatenate([np.arange(w), w - 2 - np.arange(pw)])
        layer = layer[torch.as_tensor(ridx, device=layer.device)][
            :, torch.as_tensor(cidx, device=layer.device)]
    blocks = dct.plane_blocks(layer[None], s).reshape(gh * gw, s, s)
    order = torch.as_tensor(_uniform_grid_order(h, w, s),
                            device=layer.device)
    return blocks[order]


def device_encode_uniform(rgb, space: str, block: int = 8,
                          quality_range: Tuple[int, int] = (50, 50),
                          with_edges: bool = True, device=None):
    """One (H, W, 3) sRGB image (array or tensor) -> {"coeffs": per-layer
    (n_blocks, block*block) int32 zigzag rows in preorder, "edges":
    per-layer {0, 1} edge maps (empty without with_edges)}.

    device: None means CUDA (raises when CUDA is absent); pass "cpu" for
    the plain PyTorch path."""
    dev = resolve_device(device)
    cfg = CodecConfig(space, quality_range, (block, block))
    rgb = torch.as_tensor(np.asarray(rgb, np.float32), device=dev)
    shapes = cfg.layer_shapes(tuple(rgb.shape[-3:-1]))
    mids, scales = color.normalization_constants(space)
    out = {"coeffs": [], "edges": []}
    for i, layer in enumerate(_color_and_downsample(rgb, space, shapes)):
        if with_edges:
            out["edges"].append(_canny_plane(layer))
        norm = ((layer - torch.as_tensor(mids[i], device=dev))
                * torch.as_tensor(scales[i], device=dev))
        table = quant.quantization_matrix(
            np.asarray(cfg.quantization_matrices[i]), block,
            cfg.quality_for(block))
        hi, lo = (torch.as_tensor(t, device=dev)
                  for t in quant.reciprocal_table(table))
        blocks = _extract_uniform_blocks(norm, block)
        out["coeffs"].append(dct.dct2_quantize(
            blocks, block, hi, lo, dtype=torch.int32).reshape(
                blocks.shape[0], -1))
    return out


# ------------------------------------------------------- data parallelism


def _split(b: int, mesh, data_axes) -> Tuple[List[torch.device], int]:
    devs = shard_devices(mesh, data_axes)
    if b % len(devs):
        raise ValueError(f"batch {b} not divisible by {len(devs)} devices")
    return devs, b // len(devs)


def run_shards(fn: Callable, devices: Sequence[torch.device]) -> list:
    """[fn(k, devices[k])], called in shard order from this thread with
    each shard's device current."""
    out = []
    for k, dev in enumerate(devices):
        with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
            out.append(fn(k, dev))
    return out


def sharded_dense_device_fn(cfg: CodecConfig, shape: Tuple[int, int],
                            b: int, mesh, data_axes=None):
    """The batched encoder's device side (push, stage A and stage B of
    codec/batch_encode.py) split over the mesh's data axes (default: every
    axis); b must divide evenly.

    Returns fn(host_batch (B, H, W, 3) uint8 or float32 numpy) ->
    (per-shard packed levels (B_loc, n) uint8 numpy, per-shard flat stage-B
    tables on the shard's device, possibly still being computed), shards
    in bi-major order."""
    from ..codec import batch_encode as be
    devs, b_loc = _split(b, mesh, data_axes)

    def fn(host_batch: np.ndarray):
        def shard(k, dev):
            return be._device_shard(host_batch[k * b_loc:(k + 1) * b_loc],
                                    cfg, shape, b_loc, dev)
        outs = run_shards(shard, devs)
        return [o[0] for o in outs], [o[1] for o in outs]
    return fn


def sharded_dense_decode_fn(cfg: CodecConfig, shape: Tuple[int, int],
                            b: int, mesh, data_axes=None):
    """The batched decoder's device side (upload and stage D of
    codec/batch_decode.py) split over the mesh's data axes, the decode
    mirror of `sharded_dense_device_fn`.

    Returns (fn, shard devices): fn(arenas) takes per-shard (tables, masks)
    host arenas (batch_decode.host_arenas of B_loc images, parsed) and
    returns per-shard (B_loc, H, W, 3) float32 sRGB tensors on the shards'
    devices, possibly still being computed."""
    from ..codec import batch_decode as bd
    devs, b_loc = _split(b, mesh, data_axes)

    def fn(arenas):
        def shard(k, dev):
            return bd._device_shard(*arenas[k], cfg, shape, b_loc, dev)
        return run_shards(shard, devs)
    return fn, devs
