"""h36x_torch's own zstd decoder (h36x_torch/native/zstd.cpp through
h36x_torch.utils.zstd) against the `zstandard` package, which this host
has and the port may not import: every payload that zstandard compresses
here decodes byte for byte (random, repetitive and float32-array payloads
of more than one 128 KiB block, levels 1, 3 and 19, with and without the
content checksum; streamed frames without a content size; frames one
after another with a skippable frame between them). Truncated and
corrupted frames raise ValueError; a frame naming a dictionary raises.
`compress_raw`'s frames decode in zstandard."""

import io
import struct

import numpy as np
import pytest
import zstandard

from h36x_torch.utils import zstd

N = 300_000  # bytes: three 128 KiB blocks


def payload(kind: str) -> bytes:
    rng = np.random.default_rng(7)
    if kind == "random":
        return rng.integers(0, 256, N, dtype=np.uint8).tobytes()
    if kind == "repetitive":
        words = [b"orbax", b"ocdbt", b"zarr", b"  ", rng.bytes(3)]
        return b"".join(words[i] for i in rng.integers(0, 5, N // 4))[:N]
    # float32 params and Adam moments, as a checkpoint holds them
    return (rng.standard_normal(N // 4) * 0.02).astype(np.float32).tobytes()


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", ["random", "repetitive", "float32"])
def test_decoder_equals_zstandard(kind, level, checksum):
    data = payload(kind)
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data


def test_streamed_frames_and_skippable_frames():
    """A streamed frame (no content size, several blocks), a small frame,
    a skippable frame and an empty frame, one after another."""
    data = payload("repetitive") + payload("float32")
    buf = io.BytesIO()
    with zstandard.ZstdCompressor(level=3, write_content_size=False).stream_writer(
            buf, closefd=False) as w:
        for i in range(0, len(data), 50_000):
            w.write(data[i:i + 50_000])
    skip = struct.pack("<II", 0x184D2A53, 5) + b"12345"
    frames = (buf.getvalue() + zstandard.ZstdCompressor().compress(b"tail") + skip
              + zstandard.ZstdCompressor().compress(b""))
    assert zstd.decompress(frames) == data + b"tail"


@pytest.mark.parametrize("size", [0, 10, 2 * zstd.BLOCK_MAX + 7])
def test_compress_raw_frames_decode_in_zstandard(size):
    data = np.random.default_rng(size).bytes(size)
    frame = zstd.compress_raw(data)
    assert zstandard.ZstdDecompressor().decompressobj().decompress(frame) == data
    assert zstd.decompress(frame) == data


def test_truncated_and_corrupted_frames_raise():
    data = payload("float32")[:100_000]
    frame = zstandard.ZstdCompressor(level=19, write_checksum=True).compress(data)
    for cut in range(0, len(frame), max(1, len(frame) // 97)):
        with pytest.raises(ValueError, match="corrupt zstd"):
            zstd.decompress(frame[:cut])
    rng = np.random.default_rng(0)
    for _ in range(300):  # any flipped bit: an error, never a crash
        bad = bytearray(frame)
        bad[int(rng.integers(len(bad)))] ^= 1 << int(rng.integers(8))
        with pytest.raises(ValueError, match="corrupt zstd"):
            zstd.decompress(bytes(bad))
    # without the checksum a flip may decode to other bytes, but never
    # crashes or reads out of bounds
    plain = zstandard.ZstdCompressor(level=19).compress(data)
    for _ in range(300):
        bad = bytearray(plain)
        bad[int(rng.integers(len(bad)))] ^= 1 << int(rng.integers(8))
        try:
            zstd.decompress(bytes(bad))
        except ValueError:
            pass


def test_a_dictionary_frame_raises():
    frame = struct.pack("<IBBB", zstd.MAGIC, 0x21, 7, 0) + b"\x01\x00\x00"
    with pytest.raises(ValueError, match="dictionar"):
        zstd.decompress(frame)
