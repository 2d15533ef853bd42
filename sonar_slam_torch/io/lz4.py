"""LZ4 frame codec for rosbag chunk (de)compression.

Counterpart of ``sonar_slam_tpu/io/lz4.py``. As there, decoding goes through
compiled code: :mod:`sonar_slam_torch.io.lz4_lib` (this package's own host
C++ source, built at first use) decodes frames, blocks of a known size
bound, and XXH32 over more than 4 kB. The pure-Python codec below stays as
the plain version (``decompress_block_plain``, ``decompress_frame_plain``,
``xxh32_plain``) and the compressor. The reference reads lz4-chunked bags
transparently through rosbag/roslz4 (its ``utils/io.py:130-154``); real
BlueROV recordings commonly use ``rosbag record --lz4``. No lz4 library is
assumed, so this module implements the subset of the LZ4 format that rosbag
uses, from the public format specifications:

* the LZ4 **block** format (token / literals / offset / match sequences),
* the LZ4 **frame** format v1.x (magic 0x184D2204) that roslz4's streaming
  writer produces — FLG/BD descriptor, optional content size, XXH32 header
  checksum, a sequence of (un)compressed blocks, end mark, and
* XXH32 (needed to emit valid header checksums when writing).

Decompression handles every descriptor flag roslz4 can set (block checksums
are skipped, the content checksum is verified); malformed or truncated input
raises ``ValueError`` in both decoders. Compression
is a greedy single-pass hash-chain matcher — not ratio-optimal, but formally
valid LZ4 that any conforming decoder (including roslz4) accepts.
"""

from __future__ import annotations

import struct

from . import lz4_lib

FRAME_MAGIC = 0x184D2204
LEGACY_MAGIC = 0x184C2102
_LEGACY_BLOCK = 8 << 20

# XXH32 primes
_P1, _P2, _P3, _P4, _P5 = (
    2654435761, 2246822519, 3266489917, 668265263, 374761393,
)
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    """XXH32 of ``data`` (the checksum the LZ4 frame format uses): compiled
    over more than 4 kB."""
    if len(data) > 4096:
        return lz4_lib.xxh32(data, seed)
    return xxh32_plain(data, seed)


def xxh32_plain(data: bytes, seed: int = 0) -> int:
    """XXH32 in pure Python (the plain version)."""
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M32
        v2 = (seed + _P2) & _M32
        v3 = seed
        v4 = (seed - _P1) & _M32
        while i <= n - 16:
            for vi in range(4):
                (k,) = struct.unpack_from("<I", data, i + 4 * vi)
                if vi == 0:
                    v1 = (_rotl((v1 + k * _P2) & _M32, 13) * _P1) & _M32
                elif vi == 1:
                    v2 = (_rotl((v2 + k * _P2) & _M32, 13) * _P1) & _M32
                elif vi == 2:
                    v3 = (_rotl((v3 + k * _P2) & _M32, 13) * _P1) & _M32
                else:
                    v4 = (_rotl((v4 + k * _P2) & _M32, 13) * _P1) & _M32
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i <= n - 4:
        (k,) = struct.unpack_from("<I", data, i)
        h = (_rotl((h + k * _P3) & _M32, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * _P5) & _M32, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


# ----------------------------------------------------------------------
# block codec
# ----------------------------------------------------------------------


def decompress_block(src: bytes, max_out: int | None = None) -> bytes:
    """Decode one raw LZ4 block; with ``max_out`` (the frame's declared
    block size bound) a longer output raises, and the compiled decoder
    decodes it."""
    if max_out is not None:
        return lz4_lib.decode_block(src, max_out)
    return decompress_block_plain(src)


def decompress_block_plain(src: bytes, max_out: int | None = None) -> bytes:
    """Decode one raw LZ4 block in pure Python (the plain version)."""
    try:
        return _decompress_block(src, max_out)
    except IndexError:
        raise ValueError("corrupt LZ4 block: sequence past input end") from None


def _decompress_block(src: bytes, max_out: int | None) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise ValueError("corrupt LZ4 block: literal run past input end")
        if max_out is not None and len(out) + lit > max_out:
            raise ValueError("corrupt LZ4 block: output exceeds declared size")
        out += src[i : i + lit]
        i += lit
        if i >= n:
            break  # last sequence: literals only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("corrupt LZ4 block: zero match offset")
        ml = (token & 15) + 4
        if token & 15 == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        start = len(out) - offset
        if start < 0:
            raise ValueError("corrupt LZ4 block: offset beyond output")
        if max_out is not None and len(out) + ml > max_out:
            raise ValueError("corrupt LZ4 block: output exceeds declared size")
        if offset >= ml:
            out += out[start : start + ml]
        else:
            # overlapping copy: the pattern repeats with period `offset`
            pattern = out[start:]
            reps = -(-ml // offset)
            out += (bytes(pattern) * reps)[:ml]
    return bytes(out)


def _emit_sequence(out: bytearray, literals: bytes, offset: int, mlen: int):
    lit = len(literals)
    ml = mlen - 4
    token = (min(lit, 15) << 4) | min(ml, 15)
    out.append(token)
    if lit >= 15:
        rem = lit - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += literals
    out += struct.pack("<H", offset)
    if ml >= 15:
        rem = ml - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)


def compress_block(src: bytes) -> bytes:
    """Greedy LZ4 block compression (single hash table, 64 KB window)."""
    n = len(src)
    out = bytearray()
    if n == 0:
        return bytes(out)
    anchor = 0
    i = 0
    table: dict[bytes, int] = {}
    # format rules: the last 5 bytes are always literals and no match may
    # start within the last 12 bytes (MFLIMIT)
    mflimit = n - 12
    match_limit = n - 5
    while i < mflimit:
        key = src[i : i + 4]
        j = table.get(key, -1)
        table[key] = i
        if j >= 0 and i - j <= 0xFFFF and src[j : j + 4] == key:
            m, k = i + 4, j + 4
            while m < match_limit and src[m] == src[k]:
                m += 1
                k += 1
            _emit_sequence(out, src[anchor:i], i - j, m - i)
            anchor = i = m
        else:
            i += 1
    # trailing literals
    lit = src[anchor:]
    token_lit = min(len(lit), 15)
    out.append(token_lit << 4)
    if len(lit) >= 15:
        rem = len(lit) - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += lit
    return bytes(out)


# ----------------------------------------------------------------------
# frame codec
# ----------------------------------------------------------------------


def decompress_frame(data: bytes) -> bytes:
    """Decode an LZ4 frame (or legacy-frame) byte string with the compiled
    decoder."""
    return lz4_lib.decode_frame(data)


def decompress_frame_plain(data: bytes) -> bytes:
    """Decode an LZ4 frame (or legacy-frame) byte string in pure Python (the
    plain version)."""
    try:
        return _decompress_frame(data)
    except (IndexError, struct.error):
        raise ValueError("truncated LZ4 frame") from None


def _block(data: bytes, pos: int, bsize: int) -> bytes:
    if bsize > len(data) - pos:
        raise ValueError("truncated LZ4 frame: block past input end")
    return data[pos : pos + bsize]


def _decompress_frame(data: bytes) -> bytes:
    (magic,) = struct.unpack_from("<I", data, 0)
    pos = 4
    if magic == LEGACY_MAGIC:
        out = bytearray()
        while pos + 4 <= len(data):
            (bsize,) = struct.unpack_from("<I", data, pos)
            if bsize in (FRAME_MAGIC, LEGACY_MAGIC):
                break  # next frame begins
            pos += 4
            out += decompress_block_plain(_block(data, pos, bsize),
                                          _LEGACY_BLOCK)
            pos += bsize
        return bytes(out)
    if magic != FRAME_MAGIC:
        raise ValueError(f"not an LZ4 frame (magic {magic:#x})")
    flg = data[pos]
    bd = data[pos + 1]
    pos += 2  # FLG + BD
    if flg >> 6 != 1:
        raise ValueError(f"unsupported LZ4 frame version {flg >> 6}")
    # BD bits 6-4: block max size code (4=64KB .. 7=4MB)
    bs_code = (bd >> 4) & 0x7
    block_max = 1 << (8 + 2 * max(bs_code, 4))
    block_checksum = (flg >> 4) & 1
    content_size = (flg >> 3) & 1
    content_checksum = (flg >> 2) & 1
    dict_id = flg & 1
    if content_size:
        pos += 8
    if dict_id:
        pos += 4
    pos += 1  # header checksum (HC)
    out = bytearray()
    while True:
        (bsize,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if bsize == 0:
            break  # end mark
        uncompressed = bsize >> 31
        bsize &= 0x7FFFFFFF
        block = _block(data, pos, bsize)
        pos += bsize
        out += block if uncompressed else decompress_block_plain(block,
                                                                 block_max)
        if block_checksum:
            pos += 4
    if content_checksum:
        (want,) = struct.unpack_from("<I", data, pos)
        if xxh32_plain(bytes(out)) != want:
            raise ValueError("LZ4 content checksum mismatch")
    return bytes(out)


def compress_frame(data: bytes, block_size: int = 1 << 16) -> bytes:
    """Encode ``data`` as a standard LZ4 frame (independent blocks,
    content checksum, valid XXH32 header checksum)."""
    flg = (1 << 6) | (1 << 5) | (1 << 2)  # v1, block-independent, c.checksum
    bd = 4 << 4  # max block size 64 KB
    descriptor = bytes([flg, bd])
    hc = (xxh32(descriptor) >> 8) & 0xFF
    out = bytearray(struct.pack("<I", FRAME_MAGIC) + descriptor + bytes([hc]))
    for i in range(0, len(data), block_size):
        chunk = data[i : i + block_size]
        comp = compress_block(chunk)
        if len(comp) < len(chunk):
            out += struct.pack("<I", len(comp)) + comp
        else:
            out += struct.pack("<I", len(chunk) | (1 << 31)) + chunk
    out += struct.pack("<I", 0)  # end mark
    out += struct.pack("<I", xxh32(data))
    return bytes(out)
