"""The port's image I/O: PNG (8-bit gray, gray+alpha, RGB, RGBA, every row
filter) and 24-bit BMP read and written with numpy and zlib, bitwise equal
to what imageio gives and to the JAX package's ImageData.load; other
formats through imageio; loads that need no imageio at all."""

import struct
import sys
import zlib

import imageio.v3 as iio
import numpy as np
import pytest

from aejpeg_tpu.io.image import ImageData as JImage
from aejpeg_tpu_torch.io import image as io_image
from aejpeg_tpu_torch.io.image import ImageData


def _pixels(shape, seed):
    """Smooth gradients with hard-edged blocks: u8 pixels of `shape`."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    c = 1 if len(shape) == 2 else shape[2]
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(x / rng.uniform(3, 9) + k)
                    * np.cos(y / rng.uniform(3, 9)) for k in range(c)], -1)
    for _ in range(3):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        img[y0:y0 + h // 3, x0:x0 + w // 3] = rng.random(c)
    u8 = np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)
    return u8.reshape(shape)


def _filtered_png(px: np.ndarray, ftypes) -> bytes:
    """An 8-bit PNG of px whose row r uses filter ftypes[r] (0-4)."""
    h, w = px.shape[:2]
    c = 1 if px.ndim == 2 else px.shape[2]
    x = px.reshape(h, w, c).astype(np.int32)
    left = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    up = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1]
    upleft = np.pad(x, ((1, 0), (1, 0), (0, 0)))[:-1, :-1]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = [np.zeros_like(x), left, up, (left + up) >> 1, paeth]
    rows = bytearray()
    for r in range(h):
        rows.append(ftypes[r])
        rows += ((x[r] - preds[ftypes[r]][r]) & 255).astype(np.uint8).tobytes()
    return _png(w, h, 8, {1: 0, 2: 4, 3: 2, 4: 6}[c], bytes(rows))


def _png(w, h, depth, ctype, rows: bytes) -> bytes:
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(rows))
            + chunk(b"IEND", b""))


SHAPES = {"gray": (37, 53), "gray_alpha": (23, 31, 2), "rgb": (64, 96, 3),
          "rgba": (29, 41, 4)}


@pytest.mark.parametrize("kind", list(SHAPES))
def test_png_written_by_imageio(tmp_path, kind):
    px = _pixels(SHAPES[kind], seed=1)
    path = str(tmp_path / f"{kind}.png")
    iio.imwrite(path, px)
    got = io_image.read_image(path)
    want = iio.imread(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    ours = ImageData.load(path)
    assert ours.u8_exact and ours.extension == ".png"
    if kind == "gray_alpha":
        # the JAX loader refuses 2-channel arrays; the port drops the alpha
        with pytest.raises(ValueError):
            JImage.load(path)
        np.testing.assert_array_equal(
            ours.data, np.stack([px[:, :, 0] / np.float32(255)] * 3, -1))
        return
    theirs = JImage.load(path)
    assert ours.data.dtype == theirs.data.dtype == np.float32
    np.testing.assert_array_equal(ours.data, theirs.data)
    assert ours.original_shape == theirs.original_shape
    assert ours.u8_exact == theirs.u8_exact


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba"])
def test_png_every_row_filter(tmp_path, kind):
    """Rows filtered None, Sub, Up, Average and Paeth, in a mixed order."""
    px = _pixels(SHAPES[kind], seed=2)
    ftypes = np.random.default_rng(3).integers(0, 5, px.shape[0])
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_filtered_png(px, ftypes))
    np.testing.assert_array_equal(iio.imread(path), px)
    got = io_image.read_image(path)
    assert got.dtype == np.uint8 and np.array_equal(got, px)


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom-up",
                                                          "top-down"])
def test_bmp(tmp_path, top_down):
    px = _pixels((21, 30, 3), seed=4)      # 90-byte rows: 2 bytes of pad
    path = str(tmp_path / "a.bmp")
    if top_down:
        data = bytearray(io_image._bmp_bytes(px))
        data[22:26] = struct.pack("<i", -px.shape[0])
        stride = (px.shape[1] * 3 + 3) & ~3
        rows = np.frombuffer(bytes(data[54:]), np.uint8).reshape(-1, stride)
        data[54:] = rows[::-1].tobytes()
        with open(path, "wb") as f:
            f.write(bytes(data))
    else:
        iio.imwrite(path, px)
    np.testing.assert_array_equal(iio.imread(path), px)
    np.testing.assert_array_equal(io_image.read_image(path), px)
    np.testing.assert_array_equal(ImageData.load(path).data,
                                  JImage.load(path).data)


@pytest.mark.parametrize("ext,shape", [(".png", (33, 47, 3)),
                                       (".png", (33, 47)),
                                       (".png", (33, 47, 4)),
                                       (".bmp", (33, 47, 3))])
def test_written_files_read_back_through_imageio(tmp_path, ext, shape):
    px = _pixels(shape, seed=5)
    path = str(tmp_path / f"w{ext}")
    io_image.write_image(path, px)
    np.testing.assert_array_equal(iio.imread(path), px)
    assert io_image.image_size(path) == shape[:2]


def test_save_round_trip(tmp_path):
    img = ImageData.from_array(_pixels((40, 50, 3), seed=6) / np.float32(255))
    for ext in (".png", ".bmp"):
        path = str(tmp_path / f"s{ext}")
        img.save(path)
        np.testing.assert_array_equal(iio.imread(path), img.get_uint8())
        np.testing.assert_array_equal(ImageData.load(path).data, img.data)


@pytest.fixture
def no_imageio(monkeypatch):
    for name in ("imageio", "imageio.v3"):
        monkeypatch.setitem(sys.modules, name, None)


def test_load_without_imageio(tmp_path, no_imageio):
    png, bmp = str(tmp_path / "a.png"), str(tmp_path / "a.bmp")
    px = _pixels((30, 40, 3), seed=7)
    io_image.write_image(png, px)
    io_image.write_image(bmp, px)
    for path in (png, bmp):
        np.testing.assert_array_equal(ImageData.load(path).get_uint8(), px)
    ImageData.load(png).save(str(tmp_path / "b.png"))
    tiff = tmp_path / "a.tiff"
    tiff.write_bytes(b"II*\x00" + bytes(16))
    with pytest.raises(ImportError, match=r"reading \.tiff images"):
        ImageData.load(str(tiff))
    with pytest.raises(ImportError, match=r"writing \.jpg images"):
        ImageData.load(png).save(str(tmp_path / "b.jpg"))


def test_other_png_variants_go_through_imageio(tmp_path, no_imageio):
    """A 16-bit PNG is not read by hand: without imageio it raises an
    error that names the variant."""
    path = str(tmp_path / "deep.png")
    with open(path, "wb") as f:
        f.write(_png(5, 4, 16, 2, bytes(4 * (1 + 5 * 6))))
    with pytest.raises(ImportError, match="PNG variant"):
        io_image.read_image(path)
