"""A PNG reader and writer on zlib, for the grayscale frames of the
datasets (TUM-mono, KITTI and EuRoC store 8-bit gray PNGs; 16-bit gray is
accepted too).

The JAX package decodes through PIL (ldso_tpu/io/datasets.py:18-33); the
machine with the card has no PIL, so the port reads every `.png` with this
module, on every machine, and the tests hold it against PIL. Scope:
non-interlaced grayscale (colour type 0) at bit depth 8 or 16, all five
row filters of the PNG specification (None, Sub, Up, Average, Paeth);
anything else raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the row filters. filt: (H, npix, bpp) filtered bytes; ftype:
    (H,) filter per row. In general a byte depends on its left neighbour
    (same row, one pixel back), the byte above and the one above-left, so
    all pixels on one anti-diagonal (row + pixel index = t) decode
    together."""
    H, npix, bpp = filt.shape
    if (ftype <= 2).all():
        # None, Sub and Up need no above-left byte: a row at a time, Sub as
        # a running sum along the row
        raw = np.zeros((H + 1, npix, bpp), np.uint8)
        for y in range(H):
            row = filt[y]
            if ftype[y] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif ftype[y] == 2:
                row = row + raw[y]
            raw[y + 1] = row
        return raw[1:]
    filt = filt.astype(np.int32)
    raw = np.zeros((H + 1, npix + 1, bpp), np.int32)   # row 0, column 0: zero
    for t in range(H + npix - 1):
        y = np.arange(max(0, t - npix + 1), min(H, t + 1))
        k = t - y
        a = raw[y + 1, k]           # left
        b = raw[y, k + 1]           # above
        c = raw[y, k]               # above-left
        f = ftype[y][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        raw[y + 1, k + 1] = (filt[y, k] + pred) & 0xFF
    return raw[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint8 (bit depth 8) or uint16 (bit depth 16)."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, colour, compression, method, interlace = header
    if colour != 0 or depth not in (8, 16) or interlace != 0:
        raise ValueError(
            f"unsupported PNG (colour type {colour}, bit depth {depth}, "
            f"interlace {interlace}): this reader takes non-interlaced 8- or "
            f"16-bit grayscale")
    if compression != 0 or method != 0:
        raise ValueError("unknown PNG compression or filter method")
    bpp = depth // 8
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != H * (1 + W * bpp):
        raise ValueError(f"PNG image data has {rows.size} bytes, expected "
                         f"{H * (1 + W * bpp)}")
    rows = rows.reshape(H, 1 + W * bpp)
    ftype = rows[:, 0].astype(np.int32)
    if (ftype > 4).any():
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    raw = _unfilter(rows[:, 1:].reshape(H, W, bpp), ftype)
    if depth == 8:
        return raw[..., 0].copy()
    return raw.reshape(H, W * 2).view(">u2").astype(np.uint16)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _filter(raw: np.ndarray, ftype: int) -> np.ndarray:
    """Apply one row filter to every row of (H, npix, bpp) bytes."""
    raw = raw.astype(np.int32)
    a = np.zeros_like(raw)
    a[:, 1:] = raw[:, :-1]
    b = np.zeros_like(raw)
    b[1:] = raw[:-1]
    c = np.zeros_like(raw)
    c[1:, 1:] = raw[:-1, :-1]
    pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
    return ((raw - pred) & 0xFF).astype(np.uint8)


def encode_png(img: np.ndarray, filter_type: int = 2, level: int = 6) -> bytes:
    """(H, W) uint8 or uint16 -> PNG bytes, every row with `filter_type`."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"encode_png takes an (H, W) uint8 or uint16 array, "
                         f"got {img.dtype} {img.shape}")
    if filter_type not in range(5):
        raise ValueError(f"PNG row filter must be 0..4, got {filter_type}")
    H, W = img.shape
    depth = 8 * img.itemsize
    raw = np.ascontiguousarray(img.astype(f">u{img.itemsize}")).view(np.uint8)
    filt = _filter(raw.reshape(H, W, img.itemsize), filter_type)
    rows = np.concatenate([np.full((H, 1), filter_type, np.uint8),
                           filt.reshape(H, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type: int = 2):
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type))
