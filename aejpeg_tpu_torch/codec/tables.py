"""Constant tables of the dense stages, built on the host in numpy and moved
to the device once.

For every (group, block size) of a batch geometry, stage B (encode) uses
the df32 reciprocal quantization tables, the zigzag order and the boundary
"slow" gather indices with their per-row reciprocal tables; stage D
(decode) uses the integer quantization tables and the inverse zigzag.
`host_tables` builds them with the port's own builders; `to_device` turns
any such numpy dict into device tensors (index arrays become int64).
"""

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import CodecConfig
from ..ops import quant, zigzag
from .dense import BatchSpec, batch_spec, boundary_positions


def quant_tables_np(cfg: CodecConfig, size: int):
    """(3, s, s) df32 reciprocal tables (hi, lo) + int32 Q, reference
    quality interpolation (src/jpeg/jpeg.py:688-724)."""
    his, los, qs = [], [], []
    mn = cfg.block_size_range[0]
    for li in range(3):
        q = quant.quantization_matrix(
            np.asarray(cfg.quantization_matrices[li]), size,
            cfg.quality_for(max(size, mn)))
        hi, lo = quant.reciprocal_table(q)
        his.append(hi)
        los.append(lo)
        qs.append(q)
    return np.stack(his), np.stack(los), np.stack(qs)


def slow_indices_np(lh: int, lw: int, s: int, n_planes: int):
    """Gather indices of every boundary (partial) s-block of n_planes
    (lh, lw) planes, reflect-padded against the true layer bounds exactly
    like np.pad 'reflect' (src/jpeg/jpeg.py:398-402): (pidx (N,), rows
    (N, s), cols (N, s)) int32, plane-major then boundary rank; None when
    the layer tiles evenly."""
    by, bx = boundary_positions(lh, lw, s)
    if not len(by):
        return None
    offs = np.arange(s, dtype=np.int64)[None, :]
    avail_h = np.maximum(lh - by.astype(np.int64), 1)[:, None]
    period_h = np.maximum(2 * avail_h - 2, 1)
    m = offs % period_h
    rows = by[:, None] + np.where(m < avail_h, m, period_h - m)
    avail_w = np.maximum(lw - bx.astype(np.int64), 1)[:, None]
    period_w = np.maximum(2 * avail_w - 2, 1)
    m = offs % period_w
    cols = bx[:, None] + np.where(m < avail_w, m, period_w - m)
    nb = len(by)
    pidx = np.repeat(np.arange(n_planes, dtype=np.int32), nb)
    return (pidx, np.tile(rows.astype(np.int32), (n_planes, 1)),
            np.tile(cols.astype(np.int32), (n_planes, 1)))


def host_tables(cfg: CodecConfig, shape: Tuple[int, int],
                b: Optional[int] = None
                ) -> Dict[Tuple[int, int], Dict[str, np.ndarray]]:
    """{(group, size): {name: numpy array}} for images of `shape`: hi, lo, q
    (n_l, s, s) per plane position in the group; zz, inv_zz (s*s,); and,
    given the batch size b (encode), for layers that do not tile evenly by
    s, the slow table's pidx, rows and cols (its blocks, plane-major,
    take the tables of their plane's layer: dct.dct2_quantize's group)."""
    spec = spec_for(cfg, shape)
    out = {}
    for gi, g in enumerate(spec.groups):
        lh, lw = g.shape
        for s in g.sizes:
            hi3, lo3, q3 = quant_tables_np(cfg, s)
            t = {"hi": np.stack([hi3[li] for li in g.layers]),
                 "lo": np.stack([lo3[li] for li in g.layers]),
                 "q": np.stack([q3[li] for li in g.layers]),
                 "zz": zigzag.zigzag_indices(s),
                 "inv_zz": zigzag.inverse_zigzag_indices(s)}
            slow = (None if b is None
                    else slow_indices_np(lh, lw, s, b * g.n_l))
            if slow is not None:
                t["pidx"], t["rows"], t["cols"] = slow
            out[(gi, s)] = t
    return out


_INDEX_KEYS = ("zz", "inv_zz", "pidx", "rows", "cols")


def to_device(tables: Dict[Tuple[int, int], Dict[str, np.ndarray]],
              device: torch.device
              ) -> Dict[Tuple[int, int], Dict[str, torch.Tensor]]:
    """Numpy tables -> device tensors: index arrays as int64, everything
    else in its own dtype, values unchanged."""
    out = {}
    for key, t in tables.items():
        out[key] = {
            name: torch.as_tensor(
                arr.astype(np.int64) if name in _INDEX_KEYS else arr,
                device=device)
            for name, arr in t.items()}
    return out


def spec_for(cfg: CodecConfig, shape: Tuple[int, int]) -> BatchSpec:
    mn, mx = cfg.block_size_range
    return batch_spec(cfg.layer_shapes(shape), mn, mx)


@functools.lru_cache(maxsize=32)
def device_tables(cfg: CodecConfig, shape: Tuple[int, int],
                  b: Optional[int], device: torch.device):
    """Cached to_device(host_tables(...)) per geometry and device."""
    return to_device(host_tables(cfg, shape, b), device)
