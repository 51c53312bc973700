"""Read an `.ajpg` container plainly (reference src/jpeg/jpeg.py:531-800).

    [4B BE metadata length][JSON metadata]
    per layer: [4B BE bits_len][4B BE root_size][ceil(bits_len / 8) bytes
               of 2-bit states][4B BE length][zlib stream of int32 LE
               zigzag levels, leaf after leaf in preorder]

States, in preorder with children TL, TR, BL, BR: 0 leaf, 1 split,
2 absent.  Any departure from this layout raises ValueError.
"""

import json
import zlib
from typing import List, Tuple

import numpy as np

META_KEYS = ("height", "width", "num_layers", "color_space", "quality_min",
             "quality_max", "block_size_min", "block_size_max", "extension")


def replay(states: bytes, bits_len: int, root: int
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """2-bit preorder states -> the leaves' (sizes, ys, xs) in preorder."""
    if bits_len % 2:
        raise ValueError("odd state bit length")
    bits = np.unpackbits(np.frombuffer(states, np.uint8))[:bits_len]
    codes = (bits[0::2] * 2 + bits[1::2]).tolist()
    sizes, ys, xs = [], [], []
    stack = [(0, 0, root)]
    pop, push = stack.pop, stack.extend
    i = 0
    for i, st in enumerate(codes):
        if not stack:
            raise ValueError("states past the end of the tree")
        y, x, s = pop()
        if st == 0:
            sizes.append(s)
            ys.append(y)
            xs.append(x)
        elif st == 1:
            if s < 2:
                raise ValueError("split of a 1-pixel node")
            h = s // 2
            push(((y + h, x + h, h), (y + h, x, h), (y, x + h, h),
                  (y, x, h)))
        elif st != 2:
            raise ValueError(f"state {st}")
    if stack:
        raise ValueError("tree ends before its states")
    return (np.asarray(sizes, np.int64), np.asarray(ys, np.int64),
            np.asarray(xs, np.int64))


def _u32(data: bytes, pos: int) -> Tuple[int, int]:
    if pos + 4 > len(data):
        raise ValueError("container truncated")
    return int.from_bytes(data[pos:pos + 4], "big"), pos + 4


def parse(blob: bytes):
    """-> (metadata dict, per layer {s: (ys, xs, levels)}, per layer the
    preorder leaf sizes).  Levels are (n, s*s) int64 in zigzag order."""
    if not isinstance(blob, (bytes, bytearray)) or not blob:
        raise ValueError("no container")
    n, pos = _u32(blob, 0)
    meta = json.loads(blob[pos:pos + n].decode("utf-8"))
    pos += n
    if tuple(meta) != META_KEYS:
        raise ValueError(f"metadata keys {tuple(meta)}")
    layers: List[dict] = []
    orders = []
    for _ in range(meta["num_layers"]):
        bits_len, pos = _u32(blob, pos)
        root, pos = _u32(blob, pos)
        nb = (bits_len + 7) // 8
        states = blob[pos:pos + nb]
        pos += nb
        clen, pos = _u32(blob, pos)
        if pos + clen > len(blob):
            raise ValueError("coefficient stream truncated")
        raw = zlib.decompress(blob[pos:pos + clen])
        pos += clen
        sizes, ys, xs = replay(states, bits_len, root)
        coeffs = np.frombuffer(raw, "<i4").astype(np.int64)
        if len(raw) % 4 or len(coeffs) != int((sizes ** 2).sum()):
            raise ValueError("coefficient count differs from the leaves'")
        offs = np.concatenate([[0], np.cumsum(sizes ** 2)])
        layer = {}
        for s in np.unique(sizes).tolist():
            idx = np.nonzero(sizes == s)[0]
            gather = offs[idx][:, None] + np.arange(s * s)[None, :]
            layer[s] = (ys[idx], xs[idx], coeffs[gather])
        layers.append(layer)
        orders.append(sizes)
    if pos != len(blob):
        raise ValueError("bytes after the last layer")
    return meta, layers, orders
