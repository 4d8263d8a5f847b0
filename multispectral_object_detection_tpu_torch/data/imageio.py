"""Image files without cv2 or PIL: PNG by a reader and writer of its own,
JPEG by the port's native decoder (libjpeg or nvJPEG).

The JAX package's loader decodes with ``cv2.imread`` and checks files with
PIL; neither is installed everywhere the port runs. So ``.png`` always goes
through the reader below (stdlib ``zlib`` + numpy): 8-bit gray, gray+alpha,
RGB and RGBA, not interlaced, all five row filters. ``write_png`` emits RGB
with filter-0 rows. JPEG goes through ``data/native.py``'s decoder where
libjpeg's headers exist (cv2's pixels) or CUDA's nvJPEG's do, else through
cv2 or PIL. Other formats (BMP, TIFF, ...) go through cv2 where it is importable,
else PIL, and fail with an error that names both when neither is.
``imdecode`` does the same for bytes in memory (an upload).

``jpeg_info`` reads a JPEG's size, components and EXIF orientation from its
markers, as PIL's ``Image.open`` does, without decoding it. ``imread``
turns a JPEG by its EXIF orientation (2-8: flips and transposes) as
``cv2.imread`` does; ``imdecode`` never turns an image, as the JAX REST
service's PIL decode does not.

Images are returned as (H, W, 3) uint8 RGB, what ``cv2.imread(path)[...,
::-1]`` gives: gray is replicated to three channels and alpha is dropped.
"""

from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path
from typing import BinaryIO, NamedTuple, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature; checks CRCs."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG without IEND")


def _header(body: bytes) -> Tuple[int, int, int, int]:
    """IHDR -> (width, height, colour type, interlace), 8-bit only."""
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype} (8-bit gray, gray+alpha, RGB or RGBA only)")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    return w, h, ctype, interlace


def png_size(path) -> Tuple[int, int]:
    """(width, height) of a PNG file, every chunk's CRC checked."""
    data = Path(path).read_bytes()
    size = None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            size = _header(body)[:2]
    if size is None:
        raise ValueError("PNG without IHDR")
    return size


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of decompressed scanlines (h, 1 + stride)."""
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, line = rows[y, 0], rows[y, 1:]
        if f == 0:
            cur = line
        elif f == 1:  # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:  # Up
            cur = line + prev
        elif f in (3, 4):  # Average, Paeth: sequential along the row
            cur = _unfilter_sequential(line.tolist(), prev.tolist(), bpp, f)
        else:
            raise ValueError(f"bad PNG filter type {f}")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_sequential(line: list, prev: list, bpp: int, f: int):
    cur = [0] * len(line)
    for i, x in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if f == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (x + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def read_png(path) -> np.ndarray:
    """A PNG file -> (H, W, C) uint8 with its own C (1, 2, 3 or 4)."""
    return decode_png(Path(path).read_bytes())


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with its own C (1, 2, 3 or 4)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = _header(body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, ctype, _ = header
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError("PNG image data has the wrong size")
    return _unfilter(raw, h, w * bpp, bpp).reshape(h, w, bpp)


def write_png(path, img: np.ndarray) -> None:
    """(H, W, 3) uint8 RGB -> a PNG file: filter-0 rows, zlib level 1 (the
    fast end: these files are written at run time and read once)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    h, w = img.shape[:2]
    scan = np.zeros((h, w * 3 + 1), np.uint8)
    scan[:, 1:] = img.reshape(h, -1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    Path(path).write_bytes(
        PNG_SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(scan.tobytes(), 1))
        + chunk(b"IEND", b""))


def is_jpeg(data: bytes) -> bool:
    return data[:3] == b"\xff\xd8\xff"


EXIF_ORIENTATION = 274  # the TIFF tag, in IFD0 of a JPEG's APP1 Exif block
# markers after which no length follows: TEM, RSTn, SOI, EOI, JPGn
_BARE_MARKERS = {0xC8, *range(0xD0, 0xDA), *range(0xF0, 0xFE)}
# start-of-frame kinds (baseline, progressive, lossless, arithmetic, ...)
_SOF_MARKERS = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                0xCD, 0xCE, 0xCF, 0xDE}


class JpegInfo(NamedTuple):
    width: int
    height: int
    orientation: int       # EXIF tag 274; 1 when absent or unreadable
    components: int        # 1 gray, 3 YCbCr/RGB, 4 CMYK/YCCK
    adobe_transform: int   # APP14 Adobe colour transform; -1 when absent


def _exif_orientation(block: bytes) -> int:
    """The orientation tag of an APP1 Exif payload's IFD0, 1 when it has
    none or the block does not parse (PIL and cv2 ignore such blocks)."""
    try:
        tiff = block[6:]
        e = {b"II": "<", b"MM": ">"}[tiff[:2]]
        ifd, = struct.unpack_from(e + "I", tiff, 4)
        n, = struct.unpack_from(e + "H", tiff, ifd)
        for k in range(n):
            tag, kind = struct.unpack_from(e + "HH", tiff, ifd + 2 + 12 * k)
            if tag == EXIF_ORIENTATION:
                fmt = {3: "H", 4: "I"}[kind]  # SHORT or LONG
                return struct.unpack_from(e + fmt, tiff, ifd + 10 + 12 * k)[0]
    except (KeyError, struct.error):
        pass
    return 1


def _read(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise ValueError("truncated JPEG header")
    return b


def read_jpeg_header(f: BinaryIO) -> JpegInfo:
    """Walk a JPEG's markers from SOI to the first SOS, as PIL's
    ``Image.open`` does: fill bytes and bytes between segments skipped,
    every other segment skipped by its length. Size and components come
    from the SOFn segment, the orientation from the first APP1 Exif block.
    What follows SOS (the entropy-coded data) is not read, so a file cut
    short inside it passes, as it passes PIL's ``verify``. Raises ValueError
    where PIL's open fails: no SOI, an unknown marker, a segment cut short,
    no SOFn before SOS, not 8-bit, or not 1, 3 or 4 components."""
    if f.read(3) != b"\xff\xd8\xff":
        raise ValueError("not a JPEG file")
    frame, orientation, adobe = None, None, -1
    c = 0xFF
    while True:
        if c != 0xFF:  # a byte between segments
            c = _read(f, 1)[0]
            continue
        m = _read(f, 1)[0]
        if m == 0xFF:  # fill byte
            continue
        if m < 0xC0:  # 0xFF00 is a stuffed zero, the rest are no markers
            if m:
                raise ValueError(f"no JPEG marker at 0xFF{m:02X}")
            c = _read(f, 1)[0]
            continue
        if m not in _BARE_MARKERS:
            n, = struct.unpack(">H", _read(f, 2))
            if n < 2:
                raise ValueError(f"JPEG segment 0xFF{m:02X} of length {n}")
            body = _read(f, n - 2)
            if m in _SOF_MARKERS:  # the last one before SOS counts, as in PIL
                if len(body) < 6 or body[0] != 8 or body[5] not in (1, 3, 4):
                    raise ValueError("JPEG frame: not 8-bit with 1, 3 or 4 "
                                     "components")
                frame = struct.unpack(">HH", body[1:5]) + (body[5],)
            elif m == 0xE1 and body[:6] == b"Exif\0\0" and orientation is None:
                orientation = _exif_orientation(body)
            elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
                adobe = body[11]
            if m == 0xDA:
                break
        c = _read(f, 1)[0]
    if frame is None:
        raise ValueError("JPEG without a frame header before its scan")
    h, w, comps = frame
    return JpegInfo(w, h, orientation or 1, comps, adobe)


def jpeg_info(path) -> JpegInfo:
    """``read_jpeg_header`` of a file (reads the headers only)."""
    with open(path, "rb") as f:
        return read_jpeg_header(f)


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Turn a decoded image by its EXIF orientation as cv2.imread does
    (2: mirror, 3: 180, 4: flip, 5: transpose, 6: 90 clockwise, 7:
    transverse, 8: 90 anticlockwise; other values: unchanged)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flip = {2: (slice(None), slice(None, None, -1)),
            3: (slice(None, None, -1), slice(None, None, -1)),
            4: (slice(None, None, -1),),
            6: (slice(None), slice(None, None, -1)),
            7: (slice(None, None, -1), slice(None, None, -1)),
            8: (slice(None, None, -1),)}.get(orientation)
    return np.ascontiguousarray(img[flip] if flip else img)


def imdecode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Encoded image bytes -> (H, W, 3) uint8 RGB, not turned by an EXIF
    orientation. ``name`` labels errors. Raises ImportError for a format
    that needs cv2 or PIL when neither is installed (JPEG only where no
    native decoder builds either), and ValueError for bytes no decoder
    reads."""
    return _decode(data, name, orient=False)


def _decode(data: bytes, name: str, orient: bool) -> np.ndarray:
    if data[:8] == PNG_SIGNATURE:
        im = decode_png(data)
        if im.shape[2] in (1, 2):  # gray (+ alpha)
            return np.repeat(im[:, :, :1], 3, axis=2)
        return np.ascontiguousarray(im[:, :, :3])
    orientation = 1
    if is_jpeg(data):
        from . import native

        if orient:
            try:
                orientation = read_jpeg_header(io.BytesIO(data)).orientation
            except ValueError:
                pass  # the decoder below reports what it cannot read
        if native.jpeg_available():
            try:
                return apply_orientation(native.decode_jpeg(data),
                                         orientation)
            except ValueError as e:
                raise ValueError(f"{name}: {e}") from None
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:  # cv2 turns by the EXIF tag itself
        flags = cv2.IMREAD_COLOR if orient else \
            cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION
        im = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
        if im is None:
            raise ValueError(f"cv2 cannot decode {name}")
        return np.ascontiguousarray(im[:, :, ::-1])
    try:
        from PIL import Image
    except ImportError:
        what = ("JPEG needs libjpeg's or nvJPEG's headers (jpeglib.h, "
                "nvjpeg.h), cv2 or PIL" if is_jpeg(data) else
                "only PNG and JPEG are read without cv2 or PIL")
        raise ImportError(f"{name}: {what}; install opencv-python or Pillow "
                          f"for other formats") from None
    with Image.open(io.BytesIO(data)) as im:
        return apply_orientation(np.asarray(im.convert("RGB")), orientation)


def imread(path) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB, a JPEG turned by its EXIF
    orientation as ``cv2.imread`` turns it. Raises FileNotFoundError for a
    missing file."""
    path = str(path)
    if not Path(path).is_file():
        raise FileNotFoundError(f"image not found: {path}")
    return _decode(Path(path).read_bytes(), path, orient=True)
