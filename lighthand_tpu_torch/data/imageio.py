"""Image decode, resize and affine warp for the data readers, without cv2.

The JAX package's readers decode and warp through OpenCV. The port's
counterparts are host C++ (``csrc/imageio.cpp``) with a plain C interface,
built with the host compiler into ``build/lighthand_tpu_torch/`` at first
use (``ops/kernels/_build.py``) and called through ``ctypes``, which
releases the GIL around each call, so the Loader's worker threads decode
in parallel. They give the bytes OpenCV gives:

- ``imread_rgb`` / ``imdecode_rgb``: ``cv2.imread`` / ``cv2.imdecode`` with
  ``IMREAD_COLOR`` followed by ``COLOR_BGR2RGB``, for baseline JPEG and
  PNG, with the EXIF orientation (a JPEG's APP1, a PNG's eXIf) applied;
- ``imread_gray``: ``cv2.imread(path, IMREAD_GRAYSCALE)``;
- ``resize_linear``: ``cv2.resize(img, (size, size), INTER_LINEAR)``;
- ``warp_affine_inverse``: ``cv2.warpAffine`` with ``INTER_LINEAR |
  WARP_INVERSE_MAP`` and ``borderValue=0``;
- ``encode_jpeg_rgb`` / ``imwrite_rgb``: ``cv2.imencode(".jpg", ...)`` /
  ``cv2.imwrite`` of ``cvtColor(img, COLOR_RGB2BGR)`` (or of a gray image)
  with ``IMWRITE_JPEG_QUALITY`` (95 by default): baseline, 4:2:0 for
  colour, the standard Huffman tables;
- ``encode_png_rgb``: ``cv2.imencode(".png", cvtColor(img,
  COLOR_RGB2BGR))`` as libpng writes it for OpenCV, in Python with
  ``zlib``: the SUB filter on every row (none for a 1-pixel width), level
  1 with the RLE strategy, the window cut to the image's size and the
  zlib header's window field cut as libpng cuts it, IDAT chunks of 8192
  bytes.

PNG data is inflated with Python's ``zlib`` (which also releases the GIL);
the C++ side undoes the scanline filters and converts the pixels.

Refused, with an error naming the file: progressive, arithmetic-coded,
lossless, hierarchical, 12-bit and CMYK JPEGs, and interlaced PNGs.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from typing import Sequence, Tuple, Union

import numpy as np

from lighthand_tpu_torch.ops.kernels import _build

_ERR_LEN = 256
# OpenCV's CV_IO_MAX_IMAGE_WIDTH / _HEIGHT / _PIXELS: it refuses larger
# images, and so does the port (a corrupt header must not allocate GBs)
_MAX_SIDE, _MAX_PIXELS = 1 << 20, 1 << 30
_PNG_SIG = b"\x89PNG\r\n\x1a\n"


class ImageDecodeError(ValueError):
    """An image the codec cannot read; the message names its source."""


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("imageio")
    i, i64, p, s = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p
    ip = ctypes.POINTER(ctypes.c_int)
    lib.lh_jpeg_header.argtypes = [p, i64, ip, ip, ip, s, i]
    lib.lh_jpeg_header.restype = i
    lib.lh_tiff_orientation.argtypes = [p, i64]
    lib.lh_tiff_orientation.restype = i
    lib.lh_jpeg_decode.argtypes = [p, i64, i, p, i, i, s, i]
    lib.lh_jpeg_decode.restype = i
    lib.lh_png_decode.argtypes = [p, i64, i, i, i, i, p, i, i, p, s, i]
    lib.lh_png_decode.restype = i
    lib.lh_resize_linear.argtypes = [p, i, i, i, p, i, i]
    lib.lh_resize_linear.restype = None
    lib.lh_warp_affine_inverse.argtypes = [p, i, i, i, p, p, i, i]
    lib.lh_warp_affine_inverse.restype = None
    lib.lh_jpeg_encode.argtypes = [p, i, i, i, i, p, i64,
                                   ctypes.POINTER(i64), s, i]
    lib.lh_jpeg_encode.restype = i
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _check_size(h: int, w: int, name: str) -> None:
    if not (0 < h <= _MAX_SIDE and 0 < w <= _MAX_SIDE
            and h * w <= _MAX_PIXELS):
        raise ImageDecodeError(f"{name}: image size {w}x{h} out of range")


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ExifTransform: 2-4 flip (horizontal, both, vertical), 5-8
    transpose and then flip (none, horizontal, both, vertical)."""
    if orientation >= 5:
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    if orientation in flip:
        img = np.flip(img, flip[orientation])
    return np.ascontiguousarray(img)


def _decode_jpeg(buf: bytes, gray: bool, name: str) -> np.ndarray:
    lib = _lib()
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w, orientation = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.lh_jpeg_header(buf, len(buf), ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(orientation), err, _ERR_LEN):
        raise ImageDecodeError(f"{name}: {err.value.decode()}")
    _check_size(h.value, w.value, name)
    shape = (h.value, w.value) if gray else (h.value, w.value, 3)
    out = np.empty(shape, np.uint8)
    if lib.lh_jpeg_decode(buf, len(buf), int(gray), _ptr(out), h.value,
                          w.value, err, _ERR_LEN):
        raise ImageDecodeError(f"{name}: {err.value.decode()}")
    return _orient(out, orientation.value)


def _decode_png(buf: bytes, gray: bool, name: str) -> np.ndarray:
    pos, ihdr, palette, idat, orientation = 8, None, b"", [], 1
    while pos + 8 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + length]
        crc = buf[pos + 8 + length:pos + 12 + length]
        pos += 12 + length
        if crc != struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF):
            if kind[:1].islower():  # ancillary: libpng drops it
                continue
            raise ImageDecodeError(f"{name}: PNG chunk {kind!r} fails its "
                                   "CRC")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            orientation = _lib().lh_tiff_orientation(body, len(body))
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ImageDecodeError(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, color_type, _, _, interlace = ihdr
    _check_size(h, w, name)
    if interlace:
        raise ImageDecodeError(f"{name}: interlaced PNG is not supported")
    if color_type not in (0, 2, 3, 4, 6) or depth not in (1, 2, 4, 8, 16):
        raise ImageDecodeError(f"{name}: PNG colour type {color_type} at "
                               f"bit depth {depth} is not supported")
    try:
        raw = np.frombuffer(bytearray(zlib.decompress(b"".join(idat))),
                            np.uint8)
    except zlib.error as exc:
        raise ImageDecodeError(f"{name}: {exc}") from None
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    if raw.size < h * (1 + (w * channels * depth + 7) // 8):
        raise ImageDecodeError(f"{name}: truncated PNG data")
    pal = np.frombuffer(palette or b"\0", np.uint8).copy()
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _lib().lh_png_decode(_ptr(raw), raw.size, w, h, depth, color_type,
                            _ptr(pal), len(palette) // 3, int(gray),
                            _ptr(out), err, _ERR_LEN):
        raise ImageDecodeError(f"{name}: {err.value.decode()}")
    return _orient(out, orientation)


def _decode(buf: bytes, gray: bool, name: str) -> np.ndarray:
    if buf[:2] == b"\xff\xd8":
        return _decode_jpeg(buf, gray, name)
    if buf[:8] == _PNG_SIG:
        return _decode_png(buf, gray, name)
    raise ImageDecodeError(f"{name}: neither a JPEG nor a PNG")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def imdecode_rgb(data: Union[bytes, np.ndarray],
                 name: str = "<buffer>") -> np.ndarray:
    """Encoded JPEG or PNG bytes -> RGB uint8 [H, W, 3]."""
    return _decode(bytes(data), False, name)


def imread_rgb(path: str) -> np.ndarray:
    """A JPEG or PNG file -> RGB uint8 [H, W, 3]; a missing file raises
    ``FileNotFoundError``."""
    return _decode(_read(path), False, path)


def imread_gray(path: str) -> np.ndarray:
    """A JPEG or PNG file -> gray uint8 [H, W] (``IMREAD_GRAYSCALE``)."""
    return _decode(_read(path), True, path)


def _hwc(img: np.ndarray) -> Tuple[np.ndarray, int]:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim not in (2, 3):
        raise ValueError(f"expected an HW or HWC image, got {img.shape}")
    return img, 1 if img.ndim == 2 else img.shape[2]


def resize_linear(img: np.ndarray, size: Union[int, Sequence[int]]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_LINEAR)`` for uint8
    HW or HWC images; ``size`` is one side or ``(w, h)``, as in cv2."""
    W, H = (size, size) if isinstance(size, int) else (int(size[0]),
                                                      int(size[1]))
    img, c = _hwc(img)
    h, w = img.shape[:2]
    if min(h, w, H, W) <= 0:
        raise ValueError(f"cannot resize {img.shape} to {(H, W)}")
    out = np.empty((H, W) + img.shape[2:], np.uint8)
    _lib().lh_resize_linear(_ptr(img), h, w, c, _ptr(out), H, W)
    return out


def warp_affine_inverse(img: np.ndarray, mat: np.ndarray,
                        dsize: Sequence[int]) -> np.ndarray:
    """``cv2.warpAffine(img, mat, dsize, flags=INTER_LINEAR |
    WARP_INVERSE_MAP, borderValue=0)``: ``mat`` (2x3, or the top of a 3x3)
    maps output pixels to input pixels; ``dsize`` is ``(w, h)``."""
    img, c = _hwc(img)
    m = np.ascontiguousarray(np.asarray(mat, np.float64)[:2, :3])
    W, H = int(dsize[0]), int(dsize[1])
    out = np.empty((H, W) + img.shape[2:], np.uint8)
    _lib().lh_warp_affine_inverse(_ptr(img), img.shape[0], img.shape[1], c,
                                  _ptr(m), _ptr(out), H, W)
    return out


def encode_jpeg_rgb(img: np.ndarray, quality: int = 95) -> bytes:
    """A gray uint8 [H, W] or RGB uint8 [H, W, 3] image as baseline JPEG
    bytes: ``cv2.imencode(".jpg", cvtColor(img, COLOR_RGB2BGR),
    [IMWRITE_JPEG_QUALITY, quality])`` (the image as is when gray)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError("expected a uint8 HW or HWx3 image, got "
                         f"{img.dtype} {img.shape}")
    if not 0 <= quality <= 100:
        raise ValueError(f"JPEG quality must be in [0, 100], got {quality}")
    h, w = img.shape[:2]
    # whole 16x16 MCUs, 1.5 blocks a pixel block; a block is at most
    # 27 + 63 * 26 bits, doubled for the 0xFF stuffing
    blocks = ((h + 15) // 16) * ((w + 15) // 16) * 6
    out = np.empty(2048 + blocks * 420, np.uint8)
    n = ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _lib().lh_jpeg_encode(_ptr(img), h, w, 1 if img.ndim == 2 else 3,
                             int(quality), _ptr(out), out.size,
                             ctypes.byref(n), err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return out[:n.value].tobytes()


def imwrite_rgb(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write ``encode_jpeg_rgb(img, quality)`` to ``path`` (``cv2.imwrite``
    of the BGR image)."""
    data = encode_jpeg_rgb(img, quality)
    with open(path, "wb") as f:
        f.write(data)


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _png_window(size: int) -> int:
    """libpng's deflate window bits for ``size`` bytes of filtered rows."""
    bits = 15
    if size <= 16384:
        half = 1 << 14
        while size + 262 <= half:
            half >>= 1
            bits -= 1
    return max(bits, 9)  # zlib refuses a window of 8 bits


def _png_cmf(data: bytearray, size: int) -> None:
    """libpng's ``optimize_cmf``: the zlib header's window field cut to the
    least that covers ``size``, its check bits made anew."""
    cmf = data[0]
    if size > 16384 or (cmf & 0x0F) != 8 or (cmf & 0xF0) > 0x70:
        return
    cinfo = cmf >> 4
    half = 1 << (cinfo + 7)
    if size > half:
        return
    while True:
        half >>= 1
        cinfo -= 1
        if not (cinfo > 0 and size <= half):
            break
    cmf = (cmf & 0x0F) | (cinfo << 4)
    flg = data[1] & 0xE0
    data[0] = cmf
    data[1] = flg + 0x1F - ((cmf << 8) + flg) % 0x1F


def encode_png_rgb(img: np.ndarray) -> bytes:
    """An RGB uint8 [H, W, 3] image as 8-bit RGB PNG bytes, as
    ``cv2.imencode(".png", cvtColor(img, COLOR_RGB2BGR))`` writes them."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected a uint8 HWx3 image, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    _check_size(h, w, "PNG")
    rows = img.reshape(h, w * 3)
    if w == 1:  # libpng drops SUB where a row holds one pixel
        filtered = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)
    else:
        sub = rows.copy()
        sub[:, 3:] -= rows[:, :-3]  # mod 256
        filtered = np.concatenate([np.ones((h, 1), np.uint8), sub], 1)
    raw = filtered.tobytes()
    deflate = zlib.compressobj(1, zlib.DEFLATED, _png_window(len(raw)), 8,
                               zlib.Z_RLE)
    data = bytearray(deflate.compress(raw) + deflate.flush())
    _png_cmf(data, len(raw))
    return b"".join(
        [_PNG_SIG, _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                                   0, 0, 0))]
        + [_png_chunk(b"IDAT", bytes(data[i:i + 8192]))
           for i in range(0, len(data), 8192)]
        + [_png_chunk(b"IEND", b"")])
