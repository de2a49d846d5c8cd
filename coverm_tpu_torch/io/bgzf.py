"""BGZF (blocked gzip) decode/encode.

BAM files are BGZF streams: a concatenation of gzip members, each at most
64 KiB uncompressed, with the compressed block size recorded in a gzip
extra field (``BC`` subfield).  The reference engine gets this from
htslib; here we implement it directly on zlib.  A native C++ multi-
threaded decoder (coverm_tpu/native) is used when available; this module
is the portable fallback and the encoder used for BAM writing.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# 28-byte EOF marker mandated by the SAM spec (an empty BGZF block).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HEADER = struct.Struct("<BBBBIBBH")  # magic1 magic2 CM FLG MTIME XFL OS XLEN


def decompress_all(data: bytes) -> bytes:
    """Decompress an entire BGZF (or plain gzip) byte string."""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        d = zlib.decompressobj(wbits=zlib.MAX_WBITS | 16)
        out.append(d.decompress(data[pos:]))
        consumed = n - pos - len(d.unused_data)
        if consumed <= 0:
            break
        pos += consumed
    return b"".join(out)


def iter_decompress(fileobj, chunk_size: int = 1 << 22):
    """Yield decompressed pieces of a (multi-member) BGZF/gzip stream."""
    d = zlib.decompressobj(wbits=zlib.MAX_WBITS | 16)
    while True:
        chunk = fileobj.read(chunk_size)
        if not chunk:
            break
        data = chunk
        while data:
            piece = d.decompress(data)
            if piece:
                yield piece
            if not d.eof:
                break
            data = d.unused_data
            d = zlib.decompressobj(wbits=zlib.MAX_WBITS | 16)


def decompress_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return decompress_all(f.read())


def compress_block(raw: bytes, level: int = 6) -> bytes:
    """Compress up to 64KiB of data into one BGZF block."""
    assert len(raw) <= 0x10000
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = c.compress(raw) + c.flush()
    bsize = len(payload) + 25 + 1  # header(12) + XLEN extra(6) + payload + crc(4) + isize(4)
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 8, 4,  # magic, deflate, FEXTRA
        0, 0, 0xFF,        # mtime, xfl, os
        6,                 # xlen
        0x42, 0x43, 2,     # 'B' 'C' slen=2
        bsize - 1,
    )
    return header + payload + struct.pack("<II", zlib.crc32(raw) & 0xFFFFFFFF, len(raw))


class BgzfWriter:
    """Streaming BGZF encoder (used by the BAM writer)."""

    def __init__(self, fileobj, level: int = 6):
        self._f = fileobj
        self._level = level
        self._buf = bytearray()

    def write(self, data):
        # ndarray views (zero-copy record slices) append via the buffer
        # protocol; += on a raw ndarray would broadcast instead
        if isinstance(data, np.ndarray):
            data = memoryview(data)
        self._buf += data
        while len(self._buf) >= 0xFF00:
            self._flush_block(self._buf[:0xFF00])
            del self._buf[:0xFF00]

    def _flush_block(self, raw):
        self._f.write(compress_block(bytes(raw), self._level))

    def close(self):
        if self._buf:
            self._flush_block(self._buf)
            self._buf = bytearray()
        self._f.write(BGZF_EOF)
        self._f.flush()
