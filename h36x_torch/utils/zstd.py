"""zstd frames without the zstd library.

:func:`decompress` decodes one or more zstd frames (RFC 8878) with the
port's own decoder, `h36x_torch/native/zstd.cpp`, built with g++ into the
native host library at first use (:mod:`h36x_torch.native`). There is no
fallback: where the library cannot be built, it raises. Corrupt input
raises ValueError naming what is wrong.

:func:`compress_raw` writes frames of raw (stored) blocks only: valid zstd
that any decoder reads, at no compression. The port writes checkpoints
with it and needs no compressor.
"""

from __future__ import annotations

import ctypes
import struct

from h36x_torch import native

MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024


def _lib():
    lib = native.load()
    if lib is None:
        raise RuntimeError("the port's native library (zstd decoder) could not be "
                           "built: g++ is needed to read zstd-compressed checkpoints")
    return lib


def decompress(buf) -> bytes:
    """The concatenated content of the zstd frames in `buf` (skippable
    frames skipped; the content checksum checked where a frame has one)."""
    data = bytes(buf)
    lib = _lib()
    out = ctypes.c_void_p()
    out_n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    rc = lib.h36x_zstd_decompress(data, len(data), ctypes.byref(out),
                                  ctypes.byref(out_n), err, len(err))
    if rc != 0:
        raise ValueError(f"corrupt zstd data: {err.value.decode(errors='replace')}")
    try:
        return ctypes.string_at(out.value, out_n.value) if out_n.value else b""
    finally:
        lib.h36x_zstd_free(out)


def compress_raw(buf) -> bytes:
    """One zstd frame holding `buf` in raw blocks of at most 128 KiB: the
    content size in the header (single segment), no checksum."""
    data = memoryview(bytes(buf))
    parts = [struct.pack("<IBQ", MAGIC, 0xE0, len(data))]
    pos = 0
    while True:
        size = min(BLOCK_MAX, len(data) - pos)
        last = pos + size == len(data)
        parts.append((size << 3 | int(last)).to_bytes(3, "little"))
        parts.append(data[pos:pos + size])
        pos += size
        if last:
            return b"".join(parts)
