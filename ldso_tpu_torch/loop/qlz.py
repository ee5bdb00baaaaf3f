"""QuickLZ level-1 decompression (pure Python).

DBoW3 saves binary vocabularies compressed with QuickLZ at compression
level 1 / streaming buffer 0 (thirdparty/DBoW3/src/quicklz.h:25,31;
Vocabulary.cpp:1144-1223 chunks the payload at 10000 bytes and resets the
codec state per chunk). This module implements just the decompression side
of that on-disk format so `.dbow3` files load without any native
dependency; writing uses the format's uncompressed mode (a flag in the
stream header), which the DBoW3 reader also accepts.

Stream layout (little-endian):
  byte 0   flags: bit0 = compressed, bit1 = 4-byte size fields
  then     compressed_size, decompressed_size (1 or 4 bytes each)
  payload  if bit0 == 0: raw bytes
           else: 32-bit control words, LSB-first; 0-bit = literal byte(s),
           1-bit = match of (hash-table reference, length) against the
           already-decompressed output (quicklz.c:552-727 semantics).
"""

from __future__ import annotations

_HASH_MASK = 0xFFF          # QLZ_HASH_VALUES - 1 (level 1: 4096 buckets)
_UNCOND_MATCHLEN = 6
_UNCOMPRESSED_END = 4
# number of literals encodable from the low 4 control bits (index of the
# lowest set bit; 0 -> all four positions are literals)
_BITLUT = (4, 0, 1, 0, 2, 0, 1, 0, 3, 0, 1, 0, 2, 0, 1, 0)


def size_header(buf: bytes, off: int = 0) -> int:
    return 2 * (4 if (buf[off] & 2) else 1) + 1


def size_compressed(buf: bytes, off: int = 0) -> int:
    n = 4 if (buf[off] & 2) else 1
    return int.from_bytes(buf[off + 1:off + 1 + n], "little")


def size_decompressed(buf: bytes, off: int = 0) -> int:
    n = 4 if (buf[off] & 2) else 1
    return int.from_bytes(buf[off + 1 + n:off + 1 + 2 * n], "little")


def _hash3(b0: int, b1: int, b2: int) -> int:
    fetch = b0 | (b1 << 8) | (b2 << 16)
    return ((fetch >> 12) ^ fetch) & _HASH_MASK


def decompress(buf: bytes, off: int = 0) -> bytes:
    """Decompress one QuickLZ L1 block starting at `off`. Fresh hash state
    per call (DBoW3 resets the codec between its 10000-byte chunks)."""
    flags = buf[off]
    hdr = size_header(buf, off)
    dsize = size_decompressed(buf, off)
    if not (flags & 1):                       # stored uncompressed
        return bytes(buf[off + hdr:off + hdr + dsize])

    src = off + hdr
    dst = bytearray(dsize)
    d = 0
    cword = 1
    htab = [0] * (_HASH_MASK + 1)             # position table
    hset = bytearray(_HASH_MASK + 1)          # whether a bucket was written
    last_hashed = -1                          # last output index hashed
    last_matchstart = dsize - 1 - _UNCOND_MATCHLEN - _UNCOMPRESSED_END

    def hash_upto(upto: int):
        # hash output positions (last_hashed, upto]; 3-byte reads stay in
        # bounds because callers only pass upto <= d - 3 here
        nonlocal last_hashed
        while last_hashed < upto:
            last_hashed += 1
            p = last_hashed
            h = _hash3(dst[p], dst[p + 1], dst[p + 2])
            htab[h] = p
            hset[h] = 1

    while True:
        if cword == 1:
            cword = int.from_bytes(buf[src:src + 4], "little")
            src += 4
        fetch = int.from_bytes(buf[src:src + 4], "little")

        if cword & 1:                         # match
            cword >>= 1
            h = (fetch >> 4) & _HASH_MASK
            pos = htab[h]
            if fetch & 0xF:
                mlen = (fetch & 0xF) + 2
                src += 2
            else:
                mlen = buf[src + 2]
                src += 3
            for i in range(mlen):             # overlap-safe forward copy
                dst[d + i] = dst[pos + i]
            d += mlen
            hash_upto(d - mlen)               # skip hashing inside the match
            last_hashed = d - 1
        elif d < last_matchstart:             # up to 4 literals at once
            n = _BITLUT[cword & 0xF]
            dst[d:d + n] = buf[src:src + n]
            cword >>= n
            d += n
            src += n
            hash_upto(d - 3)
        else:                                 # byte-by-byte tail
            while d < dsize:
                if cword == 1:
                    src += 4
                    cword = 1 << 31
                dst[d] = buf[src]
                d += 1
                src += 1
                cword >>= 1
            return bytes(dst)
