"""The OCDBT key-value store that orbax's tensorstore writes, read and
written without tensorstore.

An orbax checkpoint directory (`--ckpt-backend orbax`) is an OCDBT store:
a copy-on-write b-tree of byte keys (zarr paths such as
`params.input_proj.kernel/.zarray`, `params.input_proj.kernel/0.0`) to byte
values. What this reader relies on was learned from directories that
`orbax.checkpoint.StandardCheckpointer` and tensorstore write
(tests/test_torch_orbax.py holds it against both):

- Every manifest (`manifest.ocdbt`) and b-tree node starts with a 4-byte
  big-endian magic (manifest 0x0cdb3a2a, node 0x0cdb20de), the file's
  length as a u64 (little-endian), a varint format version (0) and a varint
  compression id (0 none, 1 zstd), then the body, and ends with the
  CRC-32C (Castagnoli) of everything before it, little-endian. A
  compressed body is one zstd frame.
- A manifest body: the config (16-byte uuid, varint manifest kind 0 =
  single, varint max inline value bytes, varint max decoded node bytes, u8
  version-tree arity log2, varint compression method, and for zstd an
  int32 level), then the versions inline: a data file table, varint count
  n, then column arrays of n entries each: generation (varint), root height
  (u8), root location (data file id, offset, length: varints), statistics
  (keys, tree bytes, indirect value bytes: varints) and commit time (u64 ns),
  then a varint count of older version-tree nodes (not read: the last inline
  version is the newest). An empty tree's root has offset and length
  2^64 - 1.
- A data file table: varint count n, the shared-prefix length of each path
  with the one before (n - 1 varints), each path's suffix length and its
  base-path length (n varints each), then the suffix bytes. A data file id
  indexes the table; file i lies at <store root>/<path i>. A process's
  files live under `ocdbt.process_<i>/`; the root's tree points into them
  through base paths such as `ocdbt.process_0/`.
- A b-tree node body: height (u8), a data file table, varint entry count
  n, key prefix lengths (n - 1 varints; shared with the key before), key
  suffix lengths (n varints), in an interior node the subtree-common-prefix
  length of each entry (n varints), then the key suffix bytes. A leaf (height
  0) goes on with value lengths (n varints), value kinds (n bytes: 0 inline,
  1 indirect), data file id and offset of each indirect value, and the
  inline values' bytes in order. An interior node goes on with each child's
  location (ids, offsets, lengths) and statistics (three varint columns);
  a child's keys are stored without the first common-prefix bytes of the
  entry's key, which prefix every key of the subtree.
- Values of up to the config's inline limit (1024 bytes in orbax's
  config) sit in the leaf; longer ones are indirect references into a data
  file, which may also hold b-tree nodes after the values.

The writer (:func:`write_store`) writes the two-level layout that one
orbax process writes: `ocdbt.process_0/d/<hex>` with the values and that
process's leaf, `ocdbt.process_0/manifest.ocdbt`, a root leaf `d/<hex>`
pointing into the process's data file, and the root `manifest.ocdbt`.
Bodies are stored uncompressed (compression id 0), as the format allows.
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

from h36x_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MISSING = 2 ** 64 - 1
MAX_INLINE = 1024           # orbax's config
MAX_NODE_BYTES = 100_000_000
PROCESS_DIR = "ocdbt.process_0"


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC = _crc_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), table-driven."""
    c = 0xFFFFFFFF
    table = _CRC
    for b in bytes(data):
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class Corrupt(ValueError):
    """A file of the store fails its magic, length, CRC or layout."""


class _Reader:
    def __init__(self, buf: bytes, what: str):
        self.b, self.i, self.what = buf, 0, what

    def _need(self, n: int) -> None:
        if self.i + n > len(self.b):
            raise Corrupt(f"{self.what}: truncated (needs {n} bytes at {self.i} "
                          f"of {len(self.b)})")

    def varint(self) -> int:
        out = shift = 0
        while True:
            self._need(1)
            c = self.b[self.i]
            self.i += 1
            out |= (c & 0x7F) << shift
            shift += 7
            if not c & 0x80:
                return out
            if shift > 63:
                raise Corrupt(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        self._need(n)
        out = self.b[self.i:self.i + n]
        self.i += n
        return out


def decode_file(blob: bytes, magic: int, what: str) -> bytes:
    """The body of one manifest or node file: magic, length and CRC-32C
    checked, the body decompressed where its compression id says zstd."""
    if len(blob) < 18:
        raise Corrupt(f"{what}: {len(blob)} bytes, shorter than a header")
    got = struct.unpack(">I", blob[:4])[0]
    if got != magic:
        raise Corrupt(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = struct.unpack("<Q", blob[4:12])[0]
    if length != len(blob):
        raise Corrupt(f"{what}: header says {length} bytes, file has {len(blob)}")
    want = struct.unpack("<I", blob[-4:])[0]
    crc = crc32c(blob[:-4])
    if crc != want:
        raise Corrupt(f"{what}: CRC-32C {crc:#010x} != stored {want:#010x}")
    r = _Reader(blob[:-4], what)
    r.i = 12
    version = r.varint()
    if version != 0:
        raise Corrupt(f"{what}: format version {version}, only 0 is known")
    compression = r.varint()
    body = blob[r.i:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise Corrupt(f"{what}: unknown compression id {compression}")


def encode_file(body: bytes, magic: int) -> bytes:
    """A manifest or node file around `body`: header (compression 0),
    body, CRC-32C."""
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + 2 + len(body) + 4) + b"\x00\x00"
    blob = head + body
    return blob + struct.pack("<I", crc32c(blob))


def _read_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base-path lengths: the split of each path, not needed to open it
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise Corrupt(f"{r.what}: data file path prefix past the previous path")
        path = prev[:prefix[i]] + r.raw(suffix[i])
        paths.append(path.decode())
        prev = path
    return paths


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _shared_prefixes(strings: List[bytes]) -> List[int]:
    """0, then the length of the prefix each string shares with the one
    before it."""
    out = [0]
    for prev, cur in zip(strings, strings[1:]):
        k = 0
        while k < min(len(prev), len(cur)) and prev[k] == cur[k]:
            k += 1
        out.append(k)
    return out


def _write_table(paths: List[Tuple[str, str]]) -> bytes:
    """(base path, relative path) pairs -> a data file table."""
    full = [(b + r).encode() for b, r in paths]
    shared = _shared_prefixes(full)
    out = [_varint(len(full))]
    out += [_varint(s) for s in shared[1:]]
    out += [_varint(len(p) - s) for p, s in zip(full, shared)]
    out += [_varint(len(b.encode())) for b, _ in paths]
    out += [p[s:] for p, s in zip(full, shared)]
    return b"".join(out)


class Store:
    """The newest version of the OCDBT store at `root`, read-only.

    `items()` walks the b-tree from the root manifest, checking every
    manifest's and node's magic, length and CRC-32C (`checked` counts the
    files and nodes that passed); values are read from the data files,
    which are loaded once each."""

    def __init__(self, root):
        self.root = Path(root)
        self.checked = 0
        self._files: Dict[str, bytes] = {}

    def _file(self, rel: str) -> bytes:
        if rel not in self._files:
            path = self.root / rel
            if not path.is_file():
                raise Corrupt(f"{self.root}: data file {rel} is missing")
            self._files[rel] = path.read_bytes()
        return self._files[rel]

    def _slice(self, rel: str, offset: int, length: int, what: str) -> bytes:
        data = self._file(rel)
        if offset + length > len(data):
            raise Corrupt(f"{what}: [{offset}, {offset + length}) past the end of "
                          f"{rel} ({len(data)} bytes)")
        return data[offset:offset + length]

    def _newest_root(self):
        """(data file table, root height, root location) of the newest
        version in the root manifest (its config skipped)."""
        path = self.root / "manifest.ocdbt"
        if not path.is_file():
            raise FileNotFoundError(f"{self.root}: no manifest.ocdbt (not an OCDBT store)")
        what = str(path)
        r = _Reader(decode_file(path.read_bytes(), MANIFEST_MAGIC, what), what)
        self.checked += 1
        r.raw(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise Corrupt(f"{what}: manifest kind {kind} (numbered manifests are "
                          "not read; orbax writes kind 0)")
        r.varints(2)  # max inline value bytes, max decoded node bytes
        r.raw(1)  # version-tree arity
        if r.varint() == 1:  # compression zstd: its int32 level
            r.raw(4)
        table = _read_table(r)
        n = r.varint()
        if n == 0:
            raise Corrupt(f"{what}: no versions")
        r.varints(n)  # generations
        height = r.raw(n)[-1]
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        return table, height, (ids[-1], offsets[-1], lengths[-1])

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """(key, value) of every entry, in key order."""
        table, height, (fid, offset, length) = self._newest_root()
        if offset == MISSING:
            return
        yield from self._node(table, fid, offset, length, height, b"",
                              str(self.root / "manifest.ocdbt"))

    def _node(self, table, fid, offset, length, height, prefix, parent):
        if fid >= len(table):
            raise Corrupt(f"{parent}: data file id {fid} outside its table of {len(table)}")
        rel = table[fid]
        what = f"{self.root / rel}@{offset}"
        blob = self._slice(rel, offset, length, what)
        r = _Reader(decode_file(blob, NODE_MAGIC, what), what)
        self.checked += 1
        h = r.raw(1)[0]
        if h != height:
            raise Corrupt(f"{what}: node height {h}, its parent says {height}")
        files = _read_table(r)
        n = r.varint()
        kpre = [0] + r.varints(n - 1) if n else []
        ksuf = r.varints(n)
        common = r.varints(n) if h else None
        keys, prev = [], b""
        for i in range(n):
            if kpre[i] > len(prev):
                raise Corrupt(f"{what}: key prefix past the previous key")
            key = prev[:kpre[i]] + r.raw(ksuf[i])
            keys.append(key)
            prev = key
        if h == 0:
            vlen = r.varints(n)
            kind = r.raw(n)
            ind = [i for i in range(n) if kind[i] == 1]
            if any(k > 1 for k in kind):
                raise Corrupt(f"{what}: unknown value kind")
            ids, offs = r.varints(len(ind)), r.varints(len(ind))
            values: Dict[int, bytes] = {}
            for i in range(n):
                if kind[i] == 0:
                    values[i] = r.raw(vlen[i])
            if r.i != len(r.b):
                raise Corrupt(f"{what}: {len(r.b) - r.i} bytes after the leaf's values")
            for j, i in enumerate(ind):
                if ids[j] >= len(files):
                    raise Corrupt(f"{what}: value data file id {ids[j]} outside its table")
                values[i] = self._slice(files[ids[j]], offs[j], vlen[i], what)
            for i in range(n):
                yield prefix + keys[i], values[i]
            return
        ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)
        if r.i != len(r.b):
            raise Corrupt(f"{what}: {len(r.b) - r.i} bytes after the node's entries")
        for i in range(n):
            if common[i] > len(keys[i]):
                raise Corrupt(f"{what}: subtree prefix longer than its key")
            yield from self._node(files, ids[i], offs[i], lens[i], h - 1,
                                  prefix + keys[i][:common[i]], what)

    def read_all(self) -> Dict[bytes, bytes]:
        return dict(self.items())


def _leaf(items: List[Tuple[bytes, bytes]], table: List[Tuple[str, str]],
          indirect: Dict[bytes, int]) -> bytes:
    """A leaf node body over sorted `items`; values in `indirect` (key ->
    offset in data file 0 of `table`) are references, the rest inline."""
    keys = [k for k, _ in items]
    shared = _shared_prefixes(keys)
    out = [b"\x00", _write_table(table), _varint(len(items))]
    out += [_varint(s) for s in shared[1:]]
    out += [_varint(len(k) - s) for k, s in zip(keys, shared)]
    out += [k[s:] for k, s in zip(keys, shared)]
    out += [_varint(len(v)) for _, v in items]
    out.append(bytes(int(k in indirect) for k in keys))
    ind = [k for k in keys if k in indirect]
    out += [_varint(0) for _ in ind]
    out += [_varint(indirect[k]) for k in ind]
    out += [v for k, v in items if k not in indirect]
    return b"".join(out)


def _manifest(table: List[Tuple[str, str]], root: Tuple[int, int, int],
              num_keys: int, tree_bytes: int, indirect_bytes: int) -> bytes:
    """A single-kind manifest body: orbax's config (zstd level 0), one
    version (generation 1) whose root leaf is at `root`."""
    body = [uuid.uuid4().bytes, _varint(0), _varint(MAX_INLINE), _varint(MAX_NODE_BYTES),
            b"\x04", _varint(1), struct.pack("<i", 0), _write_table(table),
            _varint(1), _varint(1), b"\x00", *(_varint(v) for v in root),
            _varint(num_keys), _varint(tree_bytes), _varint(indirect_bytes),
            struct.pack("<Q", time.time_ns()), _varint(0)]
    return encode_file(b"".join(body), MANIFEST_MAGIC)


def _atomic_write(path: Path, data: bytes) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def write_store(root, items: Dict[bytes, bytes]) -> int:
    """Write `items` as a new OCDBT store at `root` in one orbax process's
    layout (module docstring). Returns the bytes written."""
    root = Path(root)
    entries = sorted((bytes(k), bytes(v)) for k, v in items.items())
    data_name = f"d/{uuid.uuid4().hex}"
    indirect: Dict[bytes, int] = {}
    chunks, offset = [], 0
    for k, v in entries:
        if len(v) > MAX_INLINE:
            indirect[k] = offset
            chunks.append(v)
            offset += len(v)
    ind_bytes = offset
    proc_leaf = encode_file(_leaf(entries, [("", data_name)], indirect), NODE_MAGIC)
    chunks.append(proc_leaf)
    data = b"".join(chunks)
    _atomic_write(root / PROCESS_DIR / data_name, data)
    _atomic_write(root / PROCESS_DIR / "manifest.ocdbt",
                  _manifest([("", data_name)], (0, ind_bytes, len(proc_leaf)),
                            len(entries), len(proc_leaf), ind_bytes))
    root_leaf = encode_file(_leaf(entries, [(f"{PROCESS_DIR}/", data_name)], indirect),
                            NODE_MAGIC)
    root_name = f"d/{uuid.uuid4().hex}"
    _atomic_write(root / root_name, root_leaf)
    root_manifest = _manifest([("", root_name)], (0, 0, len(root_leaf)), len(entries),
                              len(root_leaf), ind_bytes)
    _atomic_write(root / "manifest.ocdbt", root_manifest)
    return len(data) + len(root_leaf) + len(root_manifest)

