"""Image loading/saving (float32 [0,1] HWC), format-normalized.

Parity with the reference Image wrapper (src/image/image.py:26-149):
grayscale is stacked to 3 channels, alpha is dropped, save scales by 255 and
casts to uint8.

8-bit PNG (gray, gray+alpha, RGB, RGBA; not interlaced; all five row
filters) and 24-bit uncompressed BMP are read and written with numpy and
zlib alone, to the arrays imageio gives for the same files.  Every other
format or variant (palette or 16-bit PNG, Adam7, TIFF, JPEG, ...) goes
through imageio, imported inside the call; where it is not installed, the
call raises an ImportError that names the format.
"""

import dataclasses
import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}          # colour type -> channels
_PNG_COLOR_TYPE = {c: t for t, c in _PNG_CHANNELS.items()}


def _imageio(what: str):
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise ImportError(
            f"{what} needs imageio, which is not installed; 8-bit PNG (gray, "
            "gray+alpha, RGB, RGBA, not interlaced) and 24-bit uncompressed "
            "BMP need only numpy and zlib") from e
    return iio


# ------------------------------------------------------------------ PNG


def _png_chunks(data: bytes):
    pos = len(_PNG_SIGNATURE)
    while pos + 12 <= len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


def _png_unfilter(ftype: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Undo the per-row PNG filters of (h, w, c) filtered bytes.  Pixel
    (r, j) depends on (r, j-1), (r-1, j) and (r-1, j-1) only, so each
    anti-diagonal r + j = d is one vectorised step over its pixels and
    channels, whatever mix of filter types the rows use."""
    h, w, c = f.shape
    x = np.zeros((h + 1, w + 1, c), np.int32)     # zero row above, column left
    fi = f.astype(np.int32)
    t_all = ftype.astype(np.int32)[:, None]
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        j = d - r
        a, b, ul = x[r + 1, j], x[r, j + 1], x[r, j]
        t = t_all[r]
        pa, pb, pc = np.abs(b - ul), np.abs(a - ul), np.abs(a + b - 2 * ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, ul))
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        x[r + 1, j + 1] = (fi[r, j] + pred) & 255
    return x[1:, 1:].astype(np.uint8)


def _read_png(data: bytes) -> Optional[np.ndarray]:
    """The pixels of an 8-bit, non-interlaced gray / gray+alpha / RGB /
    RGBA PNG as imageio gives them ((h, w) for gray, else (h, w, c)
    uint8); None for any other PNG variant."""
    ihdr, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        return None
    c = _PNG_CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    rows = np.frombuffer(raw, np.uint8, count=h * (w * c + 1)).reshape(
        h, w * c + 1)
    ftype, filtered = rows[:, 0], rows[:, 1:].reshape(h, w, c)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG row filter type {int(ftype.max())} unknown")
    px = (_png_unfilter(ftype, filtered) if ftype.any()
          else np.array(filtered))
    return px[:, :, 0] if c == 1 else px


def _png_bytes(arr: np.ndarray) -> bytes:
    """(h, w) or (h, w, c) uint8 -> an 8-bit PNG, every row filter 0."""
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    rows = np.zeros((h, 1 + w * c), np.uint8)
    rows[:, 1:] = arr.reshape(h, w * c)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (_PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         _PNG_COLOR_TYPE[c], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


# ------------------------------------------------------------------ BMP


def _read_bmp(data: bytes) -> Optional[np.ndarray]:
    """(h, w, 3) uint8 RGB of a 24-bit BI_RGB BMP (bottom-up or top-down);
    None for any other BMP variant."""
    (offset,) = struct.unpack_from("<I", data, 10)
    (hdr,) = struct.unpack_from("<I", data, 14)
    if hdr < 40:
        return None                                  # OS/2 core header
    w, h, _, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
    if bpp != 24 or comp != 0 or w <= 0 or h == 0:
        return None
    stride = (w * 3 + 3) & ~3
    rows = np.frombuffer(data, np.uint8, count=abs(h) * stride,
                         offset=offset).reshape(abs(h), stride)
    px = rows[:, :w * 3].reshape(abs(h), w, 3)[:, :, ::-1]   # BGR -> RGB
    return np.ascontiguousarray(px if h < 0 else px[::-1])


def _bmp_bytes(arr: np.ndarray) -> bytes:
    """(h, w, 3) uint8 RGB -> a bottom-up 24-bit BI_RGB BMP."""
    h, w, _ = arr.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = arr[::-1, :, ::-1].reshape(h, w * 3)
    return (b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size,
                          2835, 2835, 0, 0)
            + rows.tobytes())


# ---------------------------------------------------------------- files


def read_image(path: str) -> np.ndarray:
    """The file's pixels as imageio.v3.imread gives them."""
    with open(path, "rb") as f:
        data = f.read()
    px = None
    if data.startswith(_PNG_SIGNATURE):
        px = _read_png(data)
        what = "this PNG variant (palette, 16-bit or interlaced)"
    elif data.startswith(b"BM") and len(data) >= 34:
        px = _read_bmp(data)
        what = "this BMP variant (not 24-bit uncompressed)"
    else:
        what = f"reading {os.path.splitext(path)[1] or 'this'} images"
    if px is None:
        px = _imageio(what).imread(path)
    return px


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) of an image file: from the header alone for PNG and
    BMP, else by reading it."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head.startswith(_PNG_SIGNATURE) and head[12:16] == b"IHDR":
        w, h = struct.unpack_from(">II", head, 16)
        return h, w
    if head.startswith(b"BM") and len(head) == 26 \
            and struct.unpack_from("<I", head, 14)[0] >= 40:
        w, h = struct.unpack_from("<ii", head, 18)
        return abs(h), w
    return tuple(read_image(path).shape[:2])


def write_image(path: str, arr: np.ndarray) -> None:
    """Write uint8 pixels; .png and .bmp (RGB) without imageio."""
    ext = os.path.splitext(path)[1].lower()
    if arr.dtype == np.uint8 and ext == ".png" and (
            arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] in (2, 3, 4))):
        data = _png_bytes(arr)
    elif arr.dtype == np.uint8 and ext == ".bmp" and arr.ndim == 3 \
            and arr.shape[2] == 3:
        data = _bmp_bytes(arr)
    else:
        _imageio(f"writing {ext or 'extension-less'} images").imwrite(
            path, arr)
        return
    with open(path, "wb") as f:
        f.write(data)


@dataclasses.dataclass
class ImageData:
    data: np.ndarray                  # float32 [0,1], (H, W, 3)
    original_shape: Tuple[int, ...]
    extension: Optional[str]
    # True when `data` is exactly uint8/255 (set by the loader for 8-bit
    # sources).  Lets encode_batch upload 1 byte/sample without the full
    # round-trip equality check it otherwise runs; None = unknown (check).
    u8_exact: Optional[bool] = None

    @classmethod
    def load(cls, path: str) -> "ImageData":
        extension = os.path.splitext(path)[1]
        raw = read_image(path)
        if raw.ndim == 3 and raw.shape[2] == 2:      # gray + alpha
            raw = raw[:, :, 0]
        img = raw.astype(np.float32) / 255.0
        if img.ndim == 2:
            img = np.stack((img,) * 3, axis=-1)
        elif img.ndim == 3 and img.shape[2] == 3:
            pass
        elif img.ndim == 3 and img.shape[2] == 4:
            img = img[:, :, :3]
        else:
            raise ValueError(f"Unsupported image format: {img.shape}")
        return cls(img, img.shape, extension,
                   u8_exact=(raw.dtype == np.uint8))

    @classmethod
    def from_array(cls, data: np.ndarray,
                   shape: Optional[Tuple[int, ...]] = None,
                   extension: Optional[str] = None) -> "ImageData":
        if shape is None:
            shape = data.shape
        return cls(np.asarray(data, np.float32).reshape(shape), shape,
                   extension)

    def save(self, path: str) -> None:
        write_image(path, self.get_uint8())

    def get_uint8(self) -> np.ndarray:
        return (self.data * 255).astype(np.uint8)

    def get_flattened(self) -> np.ndarray:
        return self.data.reshape(-1, self.original_shape[-1])

    def copy(self) -> "ImageData":
        return ImageData(self.data.copy(), self.original_shape,
                         self.extension)

    @property
    def raw_rgb_bytes(self) -> int:
        """Raw uint8 RGB byte count — the compression-ratio denominator
        (reference uses PIL tobytes(): src/gui/main_frame.py:148-151)."""
        return int(np.prod(self.original_shape))
