"""`.ajpg` container framing — bit-exact with the reference format.

Layout (src/jpeg/jpeg.py:531-674):

    [4B BE metadata_len][JSON metadata]
    per layer:
        [4B BE bits_len][4B BE root_size][ceil(bits_len/8) state bytes]
        [4B BE compressed_len][zlib(level=9) of int32-LE coefficients]

Metadata JSON keys, in insertion order (src/jpeg/jpeg.py:546-556):
height, width, num_layers, color_space, quality_min, quality_max,
block_size_min, block_size_max, extension.

The zlib streams are produced by the pluggable entropy backend (Python zlib
now; the native C++ multi-stream coder drops in behind the same calls).
"""

import dataclasses
import json
import zlib
from io import BytesIO
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class LayerPayload:
    bits_len: int
    root_size: int
    states_bytes: bytes
    # int32, concatenated zigzag coefficients, preorder (None when the
    # producer supplies the deflated stream directly)
    coeffs: Optional[np.ndarray] = None
    # pre-deflated coefficient stream (the native C++ assembler compresses
    # in place; the writer passes it through untouched)
    compressed: Optional[bytes] = None


@dataclasses.dataclass
class ContainerMetadata:
    height: int
    width: int
    num_layers: int
    color_space: str
    quality_min: int
    quality_max: int
    block_size_min: int
    block_size_max: int
    extension: Optional[str]

    def to_json_bytes(self) -> bytes:
        meta = {
            "height": self.height,
            "width": self.width,
            "num_layers": self.num_layers,
            "color_space": self.color_space,
            "quality_min": self.quality_min,
            "quality_max": self.quality_max,
            "block_size_min": self.block_size_min,
            "block_size_max": self.block_size_max,
            "extension": self.extension,
        }
        return json.dumps(meta).encode("utf-8")

    @classmethod
    def from_json_bytes(cls, raw: bytes) -> "ContainerMetadata":
        m = json.loads(raw.decode("utf-8"))
        return cls(m["height"], m["width"], m["num_layers"], m["color_space"],
                   m["quality_min"], m["quality_max"], m["block_size_min"],
                   m["block_size_max"], m["extension"])


class ContainerWriter:
    def __init__(self, metadata: ContainerMetadata, compress=None):
        self.metadata = metadata
        self._compress = compress or (lambda b: zlib.compress(b, level=9))
        self._layers: List[LayerPayload] = []

    def add_layer(self, payload: LayerPayload) -> None:
        self._layers.append(payload)

    def tobytes(self) -> bytes:
        out = BytesIO()
        mb = self.metadata.to_json_bytes()
        out.write(len(mb).to_bytes(4, "big"))
        out.write(mb)
        for layer in self._layers:
            out.write(layer.bits_len.to_bytes(4, "big"))
            out.write(layer.root_size.to_bytes(4, "big"))
            out.write(layer.states_bytes)
            comp = layer.compressed
            if comp is None:
                comp = self._compress(
                    np.ascontiguousarray(layer.coeffs, dtype="<i4").tobytes())
            out.write(len(comp).to_bytes(4, "big"))
            out.write(comp)
        return out.getvalue()


class ContainerReader:
    def __init__(self, data: bytes, decompress=None):
        self._stream = BytesIO(data)
        self._decompress = decompress or zlib.decompress
        mlen = int.from_bytes(self._stream.read(4), "big")
        self.metadata = ContainerMetadata.from_json_bytes(
            self._stream.read(mlen))

    def read_layer(self) -> LayerPayload:
        payload = self.read_layer_raw()
        raw = self._decompress(payload.compressed)
        payload.coeffs = np.frombuffer(raw, dtype="<i4")
        return payload

    def read_layer_raw(self) -> LayerPayload:
        """Read one layer WITHOUT inflating the coefficient stream (the
        native batched decoder inflates in C++); `compressed` holds the
        deflated bytes, `coeffs` is None."""
        bits_len = int.from_bytes(self._stream.read(4), "big")
        root_size = int.from_bytes(self._stream.read(4), "big")
        states_bytes = self._stream.read((bits_len + 7) // 8)
        clen = int.from_bytes(self._stream.read(4), "big")
        return LayerPayload(bits_len, root_size, states_bytes,
                            compressed=self._stream.read(clen))

    def read_layers(self) -> List[LayerPayload]:
        return [self.read_layer() for _ in range(self.metadata.num_layers)]
