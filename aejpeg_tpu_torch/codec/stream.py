"""Continuous batching: stream many images through the batched pipelines.

Counterpart of the JAX package's codec/stream.py.  Incoming images are
grouped by shape into bounded batches and `lookahead` batches are kept in
flight on worker threads: the host stages of one batch (quadtree planning,
container assembly, deflate, parse; all GIL-releasing C++ or numpy)
overlap the device stages of the next, and the device runs its work in
submission order on the current stream.

Outputs always return in input order regardless of shape grouping.
"""

from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import torch

from .. import resolve_device
from ..config import CodecConfig
from ..io.container import ContainerReader
from ..io.image import ImageData
from ..utils.log import get_logger, span
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


def _mpix(images: Sequence[ImageData]) -> float:
    return round(sum(im.original_shape[0] * im.original_shape[1]
                     for im in images) / 1e6, 3)


def _encode_one(images: List[ImageData], config: CodecConfig,
                batch_no: int, device: torch.device, root) -> List[bytes]:
    log = get_logger()
    timings: Dict[str, float] = {} if log.enabled else None
    with span("encode.batch", parent=root, batch=batch_no,
              images=len(images)) as sp:
        blobs = encode_batch(images, config, timings=timings, device=device)
    if log.enabled:
        log.event("encode_batch", span=sp, batch=batch_no,
                  images=len(images), mpix=_mpix(images),
                  bytes=sum(len(x) for x in blobs), stages=timings)
    return blobs


def encode_stream(images: Sequence[ImageData], config: CodecConfig,
                  batch_size: int = 16, lookahead: int = 2,
                  device=None) -> List[bytes]:
    """Encode a mixed-shape image stream; returns blobs in input order.

    device: None means CUDA (raises when CUDA is absent); "cpu" runs the
    plain PyTorch path.  Set AEJPEG_LOG=stderr (or a file path) to trace
    it (utils/log.py): the call's root span `encode_stream` (images,
    batches, mpix), under it one `encode.batch` span a batch with its
    stage spans, and one `encode_batch` record a batch (ts, wall_s, batch,
    images, mpix, bytes, and `stages`: encode_batch's timings=, whose
    'push' and 'device' marks synchronise the device)."""
    dev = resolve_device(device)
    images = list(images)
    out: List[bytes] = [b""] * len(images)
    batches = batches_by_shape(images, batch_size)
    with span("encode_stream") as root, \
            ThreadPoolExecutor(max_workers=max(1, lookahead)) as pool:
        futs = [(idxs, pool.submit(_encode_one, [images[i] for i in idxs],
                                   config, bn, dev, root))
                for bn, idxs in enumerate(batches)]
        for idxs, fut in futs:
            for i, blob in zip(idxs, fut.result()):
                out[i] = blob
        if get_logger().enabled:
            root.attrs.update(images=len(images), batches=len(batches),
                              mpix=_mpix(images))
    return out


def _decode_group_key(blob: bytes) -> Tuple:
    m = ContainerReader(blob).metadata
    return (m.height, m.width, m.color_space, m.quality_min, m.quality_max,
            m.block_size_min, m.block_size_max)


def _decode_one(blobs: List[bytes], batch_no: int,
                device: torch.device, root) -> List[ImageData]:
    log = get_logger()
    timings: Dict[str, float] = {} if log.enabled else None
    with span("decode.batch", parent=root, batch=batch_no,
              images=len(blobs)) as sp:
        images = decode_batch(blobs, timings=timings, device=device)
    if log.enabled:
        log.event("decode_batch", span=sp, batch=batch_no,
                  images=len(blobs), mpix=_mpix(images), stages=timings)
    return images


def decode_stream(blobs: Sequence[bytes], batch_size: int = 16,
                  lookahead: int = 2, device=None) -> List[ImageData]:
    """Decode a mixed-settings blob stream; returns images in input order.
    device: as encode_stream.  Traced as encode_stream is: the root span
    `decode_stream`, one `decode.batch` span and one `decode_batch` record
    a batch."""
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
    with span("decode_stream") as root, \
            ThreadPoolExecutor(max_workers=max(1, lookahead)) as pool:
        futs = [(idxs, pool.submit(_decode_one, [blobs[i] for i in idxs],
                                   bn, dev, root))
                for bn, idxs in enumerate(batches)]
        for idxs, fut in futs:
            for i, img in zip(idxs, fut.result()):
                out[i] = img
        if get_logger().enabled:
            root.attrs.update(images=len(blobs), batches=len(batches),
                              mpix=_mpix(out))
    return out
