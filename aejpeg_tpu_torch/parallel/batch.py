"""The device encode step for a uniform block grid.

Counterpart of the single-device part of the JAX package's
parallel/batch.py.  `device_encode_uniform` runs the whole device side of
encode for one image when block_size_min == max: color convert, chroma
downsample, the Canny edge stack, normalization, Morton-ordered block
extraction, DCT, quantization and zigzag.  A uniform grid's Morton order is
the container's preorder, so its coefficient rows are the container's
coefficient stream.
"""

import functools
from typing import Tuple

import numpy as np
import torch

from .. import color, resolve_device
from ..codec.pipeline import _canny_plane, _color_and_downsample
from ..codec.quadtree import _interleave_bits
from ..config import CodecConfig
from ..ops import dct, quant, zigzag
from ..utils.mathutils import root_size_for


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
        levels = quant.quantize(
            dct.dct2(_extract_uniform_blocks(norm, block)), hi, lo)
        out["coeffs"].append(zigzag.zigzag_gather(levels))
    return out
