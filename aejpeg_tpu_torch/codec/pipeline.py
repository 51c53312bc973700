"""Per-image codec: compress(ImageData) -> .ajpg bytes, decompress(bytes) ->
ImageData.

Counterpart of the JAX package's codec/pipeline.py (behaviour of the
reference's Jpeg.compress / Jpeg.decompress, src/jpeg/jpeg.py:240-297):

  device: sRGB -> target color space -> per-layer INTER_AREA downsample
          -> edge map (the batched Canny stack on one plane)
  host:   quadtree plan per layer
  device: per block size, gather the plan's leaf blocks (reflect-padded)
          from the normalized layer -> DCT -> quantize -> zigzag
  host:   preorder coefficient stream -> deflate (on a pool thread, as
          soon as the layer's stream is built) -> .ajpg container

Decode inverts each stage: container parse -> state replay -> per size
inverse zigzag -> dequantize -> IDCT -> canvas paint -> crop ->
denormalize -> INTER_LINEAR upsample -> inverse color -> clip.

Its containers carry the same payloads as encode_batch's: the same color
and resize ops on the same layer stacks, the Canny stack per plane, and
the one DCT contraction both paths share (ops/dct.py).  The JAX package
pads each size bucket to a power-of-two capacity to bound XLA recompiles;
eager PyTorch has none to bound, so the buckets run at their true size.
"""

import os
import threading
from concurrent import futures
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import color, resolve_device
from ..config import CodecConfig
from ..io.container import (ContainerMetadata, ContainerReader,
                            ContainerWriter, LayerPayload)
from ..io.image import ImageData
from ..native import deflate_parallel
from ..ops import dct, quant, resize, zigzag
from ..ops.canny import canny
from ..ops.rounding import divide
from ..utils.log import count, span
from . import quadtree as qt


def _reflect_indices(origins: torch.Tensor, size: int, limit: int
                     ) -> torch.Tensor:
    """(n,) block origins -> (n, size) absolute indices with np.pad
    'reflect' semantics for the out-of-bounds tail (src/jpeg/jpeg.py:
    398-402)."""
    offs = torch.arange(size, device=origins.device)[None, :]
    avail = torch.clamp(limit - origins, min=1)[:, None]   # valid extent
    period = torch.clamp(2 * avail - 2, min=1)
    m = offs % period
    return origins[:, None] + torch.where(m < avail, m, period - m)


def _bucket_capacity(n: int) -> int:
    """The reference's padded bucket size (next power of two, at least
    64): its DCT is one dot over the rows of that many blocks, whose order
    the port's DCT follows (ops/dct.py)."""
    cap = 64
    while cap < n:
        cap *= 2
    return cap


def _encode_bucket(layer: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                   inv_hi: torch.Tensor, inv_lo: torch.Tensor, size: int,
                   h: int, w: int) -> torch.Tensor:
    """Gather (reflect-pad) -> DCT -> quantize -> zigzag for one bucket:
    (h, w) normalized layer, (n,) origins -> (n, size*size) int32."""
    rows = _reflect_indices(ys, size, h)
    cols = _reflect_indices(xs, size, w)
    blocks = layer[rows[:, :, None], cols[:, None, :]]       # (n, s, s)
    n = blocks.shape[0]
    return dct.dct2_quantize(blocks, size, inv_hi, inv_lo,
                             dtype=torch.int32,
                             capacity=_bucket_capacity(n)).reshape(n, -1)


def _decode_bucket(vectors: torch.Tensor, qmatrix: torch.Tensor,
                   size: int) -> torch.Tensor:
    """Inverse zigzag -> dequantize -> IDCT: (n, s*s) int32 -> (n, s, s)
    float32."""
    levels = zigzag.zigzag_scatter(vectors, size)
    return dct.idct2(quant.dequantize(levels, qmatrix),
                     capacity=_bucket_capacity(vectors.shape[0]))


def _paint_bucket(canvas: torch.Tensor, blocks: torch.Tensor,
                  ys: torch.Tensor, xs: torch.Tensor, size: int) -> None:
    """Write (n, s, s) blocks into the (root, root) canvas, in place."""
    offs = torch.arange(size, device=canvas.device)
    rows = ys[:, None] + offs[None, :]
    cols = xs[:, None] + offs[None, :]
    canvas[rows[:, :, None], cols[:, None, :]] = blocks


def _color_and_downsample(rgb: torch.Tensor, space: str,
                          layer_shapes: Tuple[Tuple[int, int], ...]
                          ) -> Tuple[torch.Tensor, ...]:
    """sRGB (H, W, 3) -> the downsampled layers (reference order: convert,
    src/jpeg/jpeg.py:262-264, then per-layer INTER_AREA resize,
    src/jpeg/jpeg.py:323-338).  Layers of one shape are resized as one
    stack, as encode_batch's stage A resizes them."""
    converted = color.convert("sRGB", space, rgb)
    layers: List[Optional[torch.Tensor]] = [None] * len(layer_shapes)
    for shape in dict.fromkeys(layer_shapes):
        idxs = [i for i, sh in enumerate(layer_shapes) if sh == shape]
        src = torch.stack([converted[..., i] for i in idxs])[None]
        out = resize.resize2d(src, shape, "area")[0]
        for j, i in enumerate(idxs):
            layers[i] = out[j]
    return tuple(layers)


_DEFLATE_POOL: Optional[futures.ThreadPoolExecutor] = None
_DEFLATE_LOCK = threading.Lock()


def _forget_deflate_pool() -> None:
    """A forked child has none of its parent's threads: it makes its own
    pool."""
    global _DEFLATE_POOL
    _DEFLATE_POOL = None


os.register_at_fork(after_in_child=_forget_deflate_pool)


def _deflate_pool() -> futures.ThreadPoolExecutor:
    """The `Codec`'s deflate workers, one a layer, made at first use.  A
    worker runs one layer's `deflate_parallel`, whose native call releases
    the GIL, so a layer deflates while the next one is built."""
    global _DEFLATE_POOL
    with _DEFLATE_LOCK:
        if _DEFLATE_POOL is None:
            _DEFLATE_POOL = futures.ThreadPoolExecutor(
                3, thread_name_prefix="aejpeg-deflate")
        return _DEFLATE_POOL


def _deflate_layer(coeffs: np.ndarray, level: int) -> bytes:
    """One layer's int32-LE coefficient stream as its zlib stream."""
    return deflate_parallel(
        np.ascontiguousarray(coeffs, dtype="<i4").tobytes(), level=level)


def _canny_plane(layer: torch.Tensor) -> torch.Tensor:
    """The batched Canny stack on one (h, w) plane."""
    return canny(layer[None])[0]


class Codec:
    """Adaptive edge-aware JPEG codec, one image at a time (API of the
    reference's `Jpeg`: compress(ImageData) -> bytes,
    decompress(bytes) -> ImageData).

    edge_fn(layer) takes an (h, w) float32 tensor and returns its {0, 1}
    float edge map (tensor or array); it defaults to the Canny stack.
    device: None means CUDA (raises when CUDA is absent); pass "cpu" for
    the plain PyTorch path."""

    def __init__(self, config: Optional[CodecConfig] = None,
                 edge_fn: Optional[Callable] = None, device=None):
        self.device = resolve_device(device)
        self.config = config or CodecConfig()
        self.edge_fn = edge_fn or _canny_plane
        self.extension: Optional[str] = None

    def update_settings(self, config: CodecConfig) -> None:
        self.config = config

    def _quant_tables(self) -> List[Dict[int, np.ndarray]]:
        cfg = self.config
        return [{s: quant.quantization_matrix(np.asarray(base), s,
                                              cfg.quality_for(s))
                 for s in cfg.block_sizes}
                for base in cfg.quantization_matrices]

    def _quant_table_for(self, tables, layer: int, size: int) -> np.ndarray:
        per_size = tables[layer]
        if size not in per_size:
            # leaves smaller than the configured minimum occur only when
            # the layer is smaller than it (the reference would KeyError)
            cfg = self.config
            per_size[size] = quant.quantization_matrix(
                np.asarray(cfg.quantization_matrices[layer]), size,
                cfg.quality_for(max(size, cfg.block_size_range[0])))
        return per_size[size]

    def _tensor(self, arr: np.ndarray, dtype=None) -> torch.Tensor:
        """A host array on the device (a blocking copy on CUDA)."""
        with span("sync.upload"):
            return torch.as_tensor(arr, dtype=dtype, device=self.device)

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        """A device tensor on the host (a blocking copy on CUDA)."""
        with span("sync.pull"):
            return t.cpu().numpy()

    # ------------------------------------------------------------- encode
    def compress(self, img: ImageData) -> bytes:
        """Traced (utils/log.py) as the root span `codec.compress`."""
        with span("codec.compress"):
            return self._compress(img)

    def _compress(self, img: ImageData) -> bytes:
        cfg = self.config
        h, w = img.original_shape[:2]
        self.extension = img.extension
        layer_shapes = cfg.layer_shapes((h, w))
        with span("codec.tables"):
            mids, scales = color.normalization_constants(cfg.color_space)
            tables = self._quant_tables()
        with span("codec.color"):
            layers = _color_and_downsample(
                self._tensor(np.asarray(img.data, np.float32)),
                cfg.color_space, layer_shapes)
        mn, mx = cfg.block_size_range
        writer = ContainerWriter(ContainerMetadata(
            height=h, width=w, num_layers=3, color_space=cfg.color_space,
            quality_min=cfg.quality_range[0], quality_max=cfg.quality_range[1],
            block_size_min=mn, block_size_max=mx, extension=img.extension))
        # a layer deflates on the pool from the moment it is packed, beside
        # the next layers' work; codec.deflate is what the request still
        # waits on
        pool = _deflate_pool()
        payloads: List[LayerPayload] = []
        pending: List[futures.Future] = []
        try:
            for i, layer in enumerate(layers):
                payloads.append(self._encode_layer(
                    i, layer, layer_shapes[i], tables, mids, scales))
                pending.append(pool.submit(
                    _deflate_layer, payloads[-1].coeffs, cfg.entropy_level))
            count("deflate_ahead", len(pending))
            with span("codec.deflate"):
                for payload, f in zip(payloads, pending):
                    payload.compressed = f.result()
                    writer.add_layer(payload)
                return writer.tobytes()
        except BaseException:
            # no deflate outlives the call, so the Codec stays reusable
            for f in pending:
                f.cancel()
            futures.wait(pending)
            raise

    def _encode_layer(self, i: int, layer: torch.Tensor,
                      shape: Tuple[int, int], tables, mids, scales
                      ) -> LayerPayload:
        """Layer `i`'s plan and coefficient stream (not yet deflated)."""
        cfg = self.config
        mn, mx = cfg.block_size_range
        lh, lw = shape
        if mn == mx:
            # uniform grid: the tree never consults edges
            with span("codec.plan"):
                plan = qt.uniform_plan(lh, lw, mn)
        else:
            with span("codec.edges"):
                edge = self.edge_fn(layer)
                if isinstance(edge, torch.Tensor):
                    edge = self._host(edge)
            with span("codec.plan"):
                plan = qt.build_plan(np.asarray(edge), mx, mn)
        with span("codec.blocks"):
            norm = (layer - self._tensor(mids[i])) \
                * self._tensor(scales[i])
            sizes64 = plan.leaf_sizes.astype(np.int64)
            offsets = np.zeros(len(sizes64) + 1, np.int64)
            np.cumsum(sizes64 * sizes64, out=offsets[1:])
            coeffs = np.empty(int(offsets[-1]), np.int32)
            for s, idx in plan.buckets().items():
                inv_hi, inv_lo = quant.reciprocal_table(
                    self._quant_table_for(tables, i, s))
                vecs = _encode_bucket(
                    norm, self._tensor(plan.leaf_y[idx], torch.int64),
                    self._tensor(plan.leaf_x[idx], torch.int64),
                    self._tensor(inv_hi), self._tensor(inv_lo), s, lh,
                    lw)
                flat_idx = (offsets[idx][:, None]
                            + np.arange(s * s, dtype=np.int64)[None, :])
                coeffs[flat_idx.ravel()] = self._host(vecs).ravel()
        with span("codec.pack"):
            states_bytes, bits_len = qt.pack_states(plan.states)
            return LayerPayload(
                bits_len=bits_len, root_size=plan.root_size,
                states_bytes=states_bytes, coeffs=coeffs)

    # ------------------------------------------------------------- decode
    def decompress(self, data: bytes) -> ImageData:
        """Traced (utils/log.py) as the root span `codec.decompress`."""
        with span("codec.decompress"):
            return self._decompress(data)

    def _decompress(self, data: bytes) -> ImageData:
        with span("codec.parse"):
            reader = ContainerReader(data)
            meta = reader.metadata
        self.config = cfg = CodecConfig(
            color_space=meta.color_space,
            quality_range=(meta.quality_min, meta.quality_max),
            block_size_range=(meta.block_size_min, meta.block_size_max))
        self.extension = meta.extension
        h, w = meta.height, meta.width
        layer_shapes = cfg.layer_shapes((h, w))
        with span("codec.tables"):
            mids, scales = color.normalization_constants(cfg.color_space)
            tables = self._quant_tables()

        ups = []
        for i in range(3):
            lh, lw = layer_shapes[i]
            with span("codec.parse"):
                payload = reader.read_layer()
                states = qt.unpack_states(payload.states_bytes,
                                          payload.bits_len)
                sizes, ys, xs = qt.replay_positions(
                    states, payload.root_size, lh, lw)
            with span("codec.blocks"):
                offsets = np.zeros(len(sizes) + 1, np.int64)
                np.cumsum(sizes.astype(np.int64) ** 2, out=offsets[1:])
                root = payload.root_size
                canvas = torch.zeros((root, root), dtype=torch.float32,
                                     device=self.device)
                for s in np.unique(sizes):
                    s = int(s)
                    idx = np.nonzero(sizes == s)[0]
                    flat_idx = (offsets[idx][:, None]
                                + np.arange(s * s, dtype=np.int64)[None, :])
                    vecs = payload.coeffs[flat_idx.ravel()].reshape(
                        len(idx), -1)
                    blocks = _decode_bucket(
                        self._tensor(vecs, torch.int32),
                        self._tensor(self._quant_table_for(tables, i, s)), s)
                    _paint_bucket(canvas, blocks,
                                  self._tensor(ys[idx], torch.int64),
                                  self._tensor(xs[idx], torch.int64), s)
            with span("codec.upsample"):
                layer = divide(canvas[:lh, :lw], float(scales[i])) \
                    + float(mids[i])
                ups.append(resize.resize2d(layer, (h, w), "linear"))

        with span("codec.color"):
            rgb = color.convert(cfg.color_space, "sRGB",      # decoded
                                torch.stack(ups, dim=-1), tiny=False)
        return ImageData(self._host(rgb), (h, w, 3), meta.extension)
