"""Per-image codec: compress(ImageData) -> .ajpg bytes, decompress(bytes) ->
ImageData.

Counterpart of the JAX package's codec/pipeline.py (behaviour of the
reference's Jpeg.compress / Jpeg.decompress, src/jpeg/jpeg.py:240-297).
It is the batched codec on one image: `compress` is encode_batch([img])
and `decompress` is decode_batch([blob])[0], so it needs the native
library as they do.  The one choice it makes otherwise is the sparse coder
of entropy level < 0: the byte-level one, whose containers are the JAX
Codec's byte for byte (encode_batch's are the JAX encode_batch's).
"""

from typing import Optional

from .. import resolve_device
from ..config import CodecConfig
from ..io.container import ContainerReader
from ..io.image import ImageData
from ..utils.log import span
from .batch_decode import decode_batch
from .batch_encode import _encode


class Codec:
    """Adaptive edge-aware JPEG codec, one image at a time (API of the
    reference's `Jpeg`: compress(ImageData) -> bytes,
    decompress(bytes) -> ImageData).

    device: None means CUDA (raises when CUDA is absent); pass "cpu" for
    the plain PyTorch path."""

    def __init__(self, config: Optional[CodecConfig] = None, device=None):
        self.device = resolve_device(device)
        self.config = config or CodecConfig()
        self.extension: Optional[str] = None

    def update_settings(self, config: CodecConfig) -> None:
        self.config = config

    def compress(self, img: ImageData) -> bytes:
        """Traced (utils/log.py) as the root span `codec.compress` over
        encode_batch's stage spans."""
        with span("codec.compress"):
            self.extension = img.extension
            return _encode([img], self.config, device=self.device,
                           sparse16=False)[0]

    def decompress(self, data: bytes) -> ImageData:
        """Traced as the root span `codec.decompress` over decode_batch's
        stage spans.  Takes its config and extension from the container."""
        with span("codec.decompress"):
            meta = ContainerReader(data).metadata
            self.config = CodecConfig(
                color_space=meta.color_space,
                quality_range=(meta.quality_min, meta.quality_max),
                block_size_range=(meta.block_size_min, meta.block_size_max))
            self.extension = meta.extension
            return decode_batch([data], device=self.device)[0]
