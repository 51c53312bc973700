"""Continuous batching: stream many images through the batched pipelines.

Counterpart of the JAX package's codec/stream.py.  Incoming images are
grouped by shape into bounded batches and `lookahead` batches are kept in
flight on worker threads: the host stages of one batch (quadtree planning,
container assembly, deflate, parse; all GIL-releasing C++ or numpy)
overlap the device stages of the next, and the device runs its work in
submission order on the current stream.

Outputs always return in input order regardless of shape grouping.
"""

import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import torch

from .. import resolve_device
from ..config import CodecConfig
from ..io.container import ContainerReader
from ..io.image import ImageData
from ..utils.log import get_logger
from .batch_decode import decode_batch
from .batch_encode import encode_batch


def batches_by_shape(images: Sequence[ImageData], batch_size: int
                     ) -> List[List[int]]:
    """Partition image indices into batches of same-shape images (input
    order preserved within each shape group)."""
    groups: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for i, img in enumerate(images):
        groups[tuple(img.original_shape[:2])].append(i)
    batches = []
    for idxs in groups.values():
        for off in range(0, len(idxs), batch_size):
            batches.append(idxs[off:off + batch_size])
    return batches


def _encode_one(images: List[ImageData], config: CodecConfig,
                batch_no: int, device: torch.device) -> List[bytes]:
    log = get_logger()
    timings: Dict[str, float] = {} if log.enabled else None
    t0 = time.perf_counter()
    blobs = encode_batch(images, config, timings=timings, device=device)
    if log.enabled:
        mpix = sum(im.original_shape[0] * im.original_shape[1]
                   for im in images) / 1e6
        wall = time.perf_counter() - t0
        log.event("encode_batch", batch=batch_no, images=len(images),
                  mpix=round(mpix, 3), wall_s=wall,
                  mpix_per_s=mpix / max(wall, 1e-9),
                  bytes=sum(len(x) for x in blobs), stages=timings)
    return blobs


def encode_stream(images: Sequence[ImageData], config: CodecConfig,
                  batch_size: int = 16, lookahead: int = 2,
                  device=None) -> List[bytes]:
    """Encode a mixed-shape image stream; returns blobs in input order.

    device: None means CUDA (raises when CUDA is absent); "cpu" runs the
    plain PyTorch path.  Set AEJPEG_LOG=stderr (or a file path) for
    per-batch structured JSON records (utils/log.py)."""
    dev = resolve_device(device)
    images = list(images)
    out: List[bytes] = [b""] * len(images)
    batches = batches_by_shape(images, batch_size)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, lookahead)) as pool:
        futs = [(idxs, pool.submit(_encode_one, [images[i] for i in idxs],
                                   config, bn, dev))
                for bn, idxs in enumerate(batches)]
        for idxs, fut in futs:
            for i, blob in zip(idxs, fut.result()):
                out[i] = blob
    log = get_logger()
    if log.enabled:
        mpix = sum(im.original_shape[0] * im.original_shape[1]
                   for im in images) / 1e6
        wall = time.perf_counter() - t0
        log.event("encode_stream", images=len(images), batches=len(batches),
                  mpix=round(mpix, 3), wall_s=wall,
                  mpix_per_s=mpix / max(wall, 1e-9))
    return out


def _decode_group_key(blob: bytes) -> Tuple:
    m = ContainerReader(blob).metadata
    return (m.height, m.width, m.color_space, m.quality_min, m.quality_max,
            m.block_size_min, m.block_size_max)


def _decode_one(blobs: List[bytes], batch_no: int,
                device: torch.device) -> List[ImageData]:
    log = get_logger()
    timings: Dict[str, float] = {} if log.enabled else None
    t0 = time.perf_counter()
    images = decode_batch(blobs, timings=timings, device=device)
    if log.enabled:
        mpix = sum(im.original_shape[0] * im.original_shape[1]
                   for im in images) / 1e6
        wall = time.perf_counter() - t0
        log.event("decode_batch", batch=batch_no, images=len(blobs),
                  mpix=round(mpix, 3), wall_s=wall,
                  mpix_per_s=mpix / max(wall, 1e-9), stages=timings)
    return images


def decode_stream(blobs: Sequence[bytes], batch_size: int = 16,
                  lookahead: int = 2, device=None) -> List[ImageData]:
    """Decode a mixed-settings blob stream; returns images in input order.
    device: as encode_stream."""
    dev = resolve_device(device)
    blobs = list(blobs)
    groups: Dict[Tuple, List[int]] = defaultdict(list)
    for i, blob in enumerate(blobs):
        groups[_decode_group_key(blob)].append(i)
    batches: List[List[int]] = []
    for idxs in groups.values():
        for off in range(0, len(idxs), batch_size):
            batches.append(idxs[off:off + batch_size])
    out: List[ImageData] = [None] * len(blobs)  # type: ignore[list-item]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, lookahead)) as pool:
        futs = [(idxs, pool.submit(_decode_one, [blobs[i] for i in idxs],
                                   bn, dev))
                for bn, idxs in enumerate(batches)]
        for idxs, fut in futs:
            for i, img in zip(idxs, fut.result()):
                out[i] = img
    log = get_logger()
    if log.enabled:
        mpix = sum(im.original_shape[0] * im.original_shape[1]
                   for im in out) / 1e6
        wall = time.perf_counter() - t0
        log.event("decode_stream", images=len(blobs), batches=len(batches),
                  mpix=round(mpix, 3), wall_s=wall,
                  mpix_per_s=mpix / max(wall, 1e-9))
    return out
