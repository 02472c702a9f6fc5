"""Zstandard frames and CRC32C for the orbax checkpoint format.

``decompress`` and ``crc32c`` call the host C++ library
(``native/zstd.cpp``, built at first use); ``compress_stored`` writes a
valid zstd frame of raw (stored) blocks in Python: every zstd decoder reads
it, orbax and tensorstore included, and it costs no compression time.
"""
from __future__ import annotations

import ctypes
import struct

from .. import native

MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024


def _buffer(data):
    """A pointer to ``data``'s bytes and its length (the bytes object
    stays alive in the caller)."""
    data = bytes(data)
    return data, ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p), len(data)


def decompress(data) -> bytes:
    """The content of every zstd frame in ``data``, concatenated (skippable
    frames give nothing). Raises ``ValueError`` on a corrupt frame, a
    dictionary, a bad content checksum or output past the stated size."""
    lib = native.load_zstd()
    keep, ptr, n = _buffer(data)
    out_len = ctypes.c_int64(0)
    err = ctypes.create_string_buffer(256)
    out = lib.tt_zstd_decompress(ptr, n, ctypes.byref(out_len), err,
                                 len(err))
    if not out:
        raise ValueError(err.value.decode() or "zstd: decode failed")
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.tt_zstd_free(out)


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    keep, ptr, n = _buffer(data)
    return native.load_zstd().tt_crc32c(ptr, n, crc)


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (a zstd frame's content checksum is its low 32
    bits)."""
    keep, ptr, n = _buffer(data)
    return native.load_zstd().tt_xxh64(ptr, n, seed)


def compress_stored(data) -> bytes:
    """One zstd frame holding ``data`` in raw blocks of at most 128 KiB,
    with its content size and no checksum."""
    data = bytes(data)
    n = len(data)
    # frame header: an 8-byte content size, no window descriptor (single
    # segment), no dictionary, no checksum
    out = bytearray(struct.pack("<IB", MAGIC, 0xE0))
    out += struct.pack("<Q", n)
    pos = 0
    while True:
        size = min(BLOCK_MAX, n - pos)
        last = pos + size == n
        # block header: last flag, type 0 (raw), size
        out += struct.pack("<I", (size << 3) | int(last))[:3]
        out += data[pos:pos + size]
        pos += size
        if last:
            return bytes(out)
