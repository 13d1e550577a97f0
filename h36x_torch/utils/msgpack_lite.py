"""A small msgpack decoder and encoder for flax checkpoints, numpy only.

The port reads and writes flax's msgpack files (`flax.serialization`
`to_bytes` / `msgpack_restore`) without the `msgpack` package. It covers:

- maps, arrays, str, bin, ints, floats, bool and nil;
- flax's ext types: code 1, an ndarray packed as msgpack
  `(shape, dtype.name, bytes)`, and code 3, a numpy scalar in the same
  form (`flax/serialization.py::_ndarray_to_bytes`, `_msgpack_ext_unpack`);
- flax's `__msgpack_chunked_array__` maps (arrays split for msgpack's 2 GiB
  object limit), joined back into one array.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buf = unpackb(payload)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, payload: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _decode(r: _Reader):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
        return bytes(r.take(r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
    if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in ints:
        return r.unpack(ints[b])
    if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):  # fixext 1/2/4/8/16
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(1 << (b - 0xD4))))
    if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
        return str(r.take(r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])), "utf-8")
    if b in (0xDC, 0xDD):  # array 16/32
        return [_decode(r) for _ in range(r.unpack(">H" if b == 0xDC else ">I"))]
    if b in (0xDE, 0xDF):  # map 16/32
        return _map(r, r.unpack(">H" if b == 0xDE else ">I"))
    raise ValueError(f"invalid msgpack type byte 0x{b:02x}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _decode(r)
        out[key] = _decode(r)
    if out.get(_CHUNKED) is True:
        return _unchunk(out)
    return out


def _unchunk(d: dict) -> np.ndarray:
    try:
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    except (KeyError, TypeError) as e:
        raise ValueError(f"malformed {_CHUNKED} leaf: {e}") from e
    return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)


def unpackb(data: bytes):
    """Decode one msgpack object (flax checkpoint blob) to Python/numpy."""
    r = _Reader(data)
    obj = _decode(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after msgpack object")
    return obj


def _header(out: list, n: int, fix: int, fix_max: int, codes) -> None:
    if n <= fix_max:
        out.append(struct.pack(">B", fix | n))
    elif codes[0] is not None and n < 1 << 8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _encode(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        # the smallest form, as msgpack-python (flax's packer) writes it
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out.append(struct.pack(">b" if obj < 0 else ">B", obj))
        elif obj >= 0:
            for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                                   (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
                if obj < top:
                    out.append(struct.pack(fmt, code, obj))
                    break
        else:
            for code, fmt, low in ((0xD0, ">Bb", -(1 << 7)), (0xD1, ">Bh", -(1 << 15)),
                                   (0xD2, ">Bi", -(1 << 31)), (0xD3, ">Bq", -(1 << 63))):
                if obj >= low:
                    out.append(struct.pack(fmt, code, obj))
                    break
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _header(out, len(raw), 0, -1, (0xC4, 0xC5, 0xC6))
        out.append(raw)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)  # np.ascontiguousarray would make 0-d arrays 1-d
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")
        payload = packb((list(arr.shape), arr.dtype.name, arr.tobytes()))
        code = EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(struct.pack(">Bb", fixext[n], code))
        elif n < 1 << 8:
            out.append(struct.pack(">BBb", 0xC7, n, code))
        elif n < 1 << 16:
            out.append(struct.pack(">BHb", 0xC8, n, code))
        else:
            out.append(struct.pack(">BIb", 0xC9, n, code))
        out.append(payload)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for item in obj:
            _encode(item, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _encode(key, out)
            _encode(value, out)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode a tree of dict/list/str/bytes/int/float/bool/None and numpy
    arrays or scalars (flax's ext types) to msgpack bytes."""
    out: list = []
    _encode(obj, out)
    return b"".join(out)
