"""The feature-shard store (counterpart of h36x/data/shards.py).

The format is h36x's, so a store written by either package reads the same
in the other. A shard file `shard_XXXXX.h36x` is

    bytes 0..8      magic b"H36XSHRD"
    bytes 8..12     uint32 LE header length H
    bytes 12..12+H  JSON header {"version": 1, "n_vars": int,
                    "arrays": {name: {"dtype", "shape", "offset", "nbytes",
                    "crc32"}}, "meta": [per-row dicts]}
    payload         little-endian raw arrays at 64-byte-aligned offsets

where "crc32" is the zlib CRC32 of the array's payload bytes. A shard holds
N_clips x n_vars rows, a clip's variants contiguous. `index.json` maps
clips to (shard, row).

bfloat16 arrays: numpy has no bfloat16, so on the host the port holds one
as its raw bits, a little-endian uint16 array; "bfloat16" is the name such
an array is written under, and reading that name gives `<u2` back. The
device feed views those bits as `torch.bfloat16`
(:func:`h36x_torch.parallel.feed.to_device`); :func:`bf16_bits` and
:func:`bf16_tensor` convert between the two. No store dtype is uint16
otherwise.

:func:`merge_stores` unifies the part stores of a partitioned extraction;
:func:`load_torch_index` / :func:`load_torch_shard` read the reference's
torch `.pt` stores (`index.pt`, `shard_XXXXX.pt`).
"""

from __future__ import annotations

import json
import os
import sys
import zlib
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

MAGIC = b"H36XSHRD"
_ALIGN = 64
_HOST_LE = sys.byteorder == "little"

ARRAY_KEYS = ("feats", "joints3d", "joints2d", "K")

_DTYPE_NAMES = {"float32", "float16", "bfloat16", "float64", "int32", "int64", "uint8"}
BF16_BITS = np.dtype("<u2")  # a bfloat16 array's host form: its raw bits


def np_dtype(name: str) -> np.dtype:
    """The little-endian numpy dtype of a shard dtype name ("bfloat16":
    uint16, the raw bits)."""
    if name not in _DTYPE_NAMES:
        raise ValueError(f"unsupported shard dtype {name!r} (h36x_torch reads "
                         f"{sorted(_DTYPE_NAMES)})")
    if name == "bfloat16":
        return BF16_BITS
    return np.dtype(name).newbyteorder("<")


def dtype_name(dt: np.dtype) -> str:
    """The shard dtype name of a numpy dtype (uint16: "bfloat16")."""
    name = "bfloat16" if dt.kind == "u" and dt.itemsize == 2 else dt.name
    if name not in _DTYPE_NAMES:
        raise ValueError(f"unsupported shard dtype {dt!r}")
    return name


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A torch.bfloat16 tensor's raw bits as a numpy uint16 array (CPU)."""
    return t.detach().cpu().contiguous().view(torch.uint16).numpy()


def bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """uint16 bits -> a torch.bfloat16 tensor sharing their memory (no
    float32 copy)."""
    return torch.from_numpy(np.ascontiguousarray(bits)).view(torch.bfloat16)


def as_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host shard array as a CPU tensor sharing its memory: bf16 bits
    (uint16) as torch.bfloat16, another array as its own dtype."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == BF16_BITS:
        return bf16_tensor(arr)
    return torch.from_numpy(arr)


def host_array(arr) -> np.ndarray:
    """A shard array as numpy: a torch.bfloat16 tensor as its bits, another
    tensor as its values."""
    if isinstance(arr, torch.Tensor):
        return bf16_bits(arr) if arr.dtype == torch.bfloat16 else arr.detach().cpu().numpy()
    return np.asarray(arr)


def shard_path(root, shard_id: int) -> Path:
    return Path(root) / f"shard_{shard_id:05d}.h36x"


def write_shard(path, arrays: Dict[str, np.ndarray], meta: List[dict], n_vars: int) -> None:
    """Serialize one shard (atomic rename). `arrays` share the leading row
    count; a value may be a numpy array or a tensor (a torch.bfloat16 one,
    or a uint16 array of bf16 bits, is written as "bfloat16")."""
    arrays = {k: host_array(v) for k, v in arrays.items()}
    rows = {k: int(v.shape[0]) for k, v in arrays.items()}
    if len(set(rows.values())) != 1:
        raise ValueError(f"inconsistent row counts: {rows}")
    n_rows = next(iter(rows.values()))
    if len(meta) != n_rows:
        raise ValueError(f"meta has {len(meta)} entries for {n_rows} rows")

    header: dict = {"version": 1, "n_vars": int(n_vars), "arrays": {}, "meta": meta}
    entries = {}
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype.byteorder == ">" or (arr.dtype.byteorder == "=" and not _HOST_LE):
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        entries[name] = arr
        header["arrays"][name] = {
            "dtype": dtype_name(arr.dtype),
            "shape": list(arr.shape),
            "offset": 0,
            "nbytes": int(arr.nbytes),
            "crc32": zlib.crc32(arr.data) & 0xFFFFFFFF,
        }

    def layout(header_len: int) -> None:
        off = len(MAGIC) + 4 + header_len
        for name in entries:
            off = (off + _ALIGN - 1) // _ALIGN * _ALIGN
            header["arrays"][name]["offset"] = off
            off += header["arrays"][name]["nbytes"]

    # the offsets are written into the header, whose length moves them:
    # repeat until the header length settles
    blob = json.dumps(header).encode()
    layout(len(blob))
    blob2 = json.dumps(header).encode()
    while len(blob2) != len(blob):
        blob = blob2
        layout(len(blob))
        blob2 = json.dumps(header).encode()

    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(np.array(len(blob2), dtype="<u4").tobytes())
        f.write(blob2)
        for name, arr in entries.items():
            f.seek(header["arrays"][name]["offset"])
            f.write(arr.data)
    os.replace(tmp, path)


def read_shard(path, mmap: bool = True) -> dict:
    """Load a shard into {'feats': ..., 'joints3d': ..., ..., 'meta': [...],
    'n_vars': int}; with mmap=True the arrays are memory-mapped."""
    path = str(path)
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not an h36x shard")
        (hlen,) = np.frombuffer(f.read(4), dtype="<u4")
        header = json.loads(f.read(int(hlen)).decode())

    out: dict = {"meta": header["meta"], "n_vars": header["n_vars"]}
    for name, spec in header["arrays"].items():
        dt = np_dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        if mmap:
            arr = np.memmap(path, dtype=dt, mode="r", offset=spec["offset"], shape=shape)
        else:
            arr = np.fromfile(path, dtype=dt, count=int(np.prod(shape)),
                              offset=spec["offset"]).reshape(shape)
        out[name] = arr
    return out


class ShardWriter:
    """Writes numbered shard files, one per `write` call; with an
    `async_writer` (:class:`h36x_torch.extract.writer.AsyncWriter`) the
    serialization runs on its thread, in submission order."""

    def __init__(self, out_root, n_vars: int, async_writer=None):
        self.out_root = Path(out_root)
        self.out_root.mkdir(parents=True, exist_ok=True)
        self.n_vars = n_vars
        self.shard_id = 0
        self._async = async_writer

    def write(self, arrays: Dict[str, np.ndarray], meta: List[dict]) -> int:
        sid = self.shard_id
        path = shard_path(self.out_root, sid)
        if self._async is not None:
            self._async.submit(write_shard, path, arrays, meta, self.n_vars)
        else:
            write_shard(path, arrays, meta, self.n_vars)
        self.shard_id += 1
        return sid


def verify_store(root) -> dict:
    """Integrity check of a store: read every shard in full (no mmap),
    recompute each array's recorded CRC32, check payload sizes, row counts
    and meta lengths, and that the index's clip -> shard mapping agrees with
    what is on disk.

    Returns {"n_shards", "rows", "arrays_checked", "arrays_unchecked",
    "errors": [str]}; `arrays_unchecked` counts arrays written without a
    checksum. Raises for a reference `.pt` store, which has no checksums."""
    root = Path(root)
    idx = load_index(root)
    if idx.get("torch_format"):
        raise ValueError("checksum verification covers native .h36x stores; reference "
                         ".pt stores carry no integrity records")
    n_shards = int(idx["n_shards"])
    n_vars = int(idx["n_variants"])
    per_shard: Dict[int, int] = {}
    for c in idx["clips"]:
        sid = int(c["shard_id"])
        per_shard[sid] = per_shard.get(sid, 0) + 1
    errors: List[str] = [
        f"index maps {n} clip(s) to nonexistent shard {sid} (store has {n_shards})"
        for sid, n in per_shard.items() if sid < 0 or sid >= n_shards]
    rows = checked = unchecked = 0
    for sid in range(n_shards):
        path = shard_path(root, sid)
        shard_rows = None
        try:
            with open(path, "rb") as f:
                if f.read(len(MAGIC)) != MAGIC:
                    raise ValueError("bad magic")
                (hlen,) = np.frombuffer(f.read(4), dtype="<u4")
                header = json.loads(f.read(int(hlen)).decode())
                for name, spec in header["arrays"].items():
                    f.seek(int(spec["offset"]))
                    buf = f.read(int(spec["nbytes"]))
                    if len(buf) != int(spec["nbytes"]):
                        errors.append(f"{path.name}:{name}: truncated "
                                      f"({len(buf)}/{spec['nbytes']} payload bytes)")
                        continue
                    want = spec.get("crc32")
                    if want is None:
                        unchecked += 1
                    elif zlib.crc32(buf) & 0xFFFFFFFF != int(want):
                        errors.append(f"{path.name}:{name}: CRC32 mismatch "
                                      f"(recorded {int(want):#010x}) — payload corrupted")
                    else:
                        checked += 1
                    if spec["shape"]:
                        if shard_rows is None:
                            shard_rows = int(spec["shape"][0])
                        elif int(spec["shape"][0]) != shard_rows:
                            errors.append(f"{path.name}: arrays disagree on row "
                                          f"count ({spec['shape'][0]} vs {shard_rows})")
                if shard_rows is not None and len(header["meta"]) != shard_rows:
                    errors.append(f"{path.name}: {len(header['meta'])} meta entries "
                                  f"for {shard_rows} rows")
        except Exception as e:  # noqa: BLE001 — report, keep scanning
            errors.append(f"{path.name}: unreadable ({type(e).__name__}: {e})")
            continue
        expect = per_shard.get(sid, 0) * n_vars
        if shard_rows is not None and shard_rows != expect:
            errors.append(f"{path.name}: {shard_rows} rows on disk but the index "
                          f"maps {per_shard.get(sid, 0)} clip(s) x {n_vars} "
                          f"variants = {expect}")
        rows += shard_rows or 0
    return {"n_shards": n_shards, "rows": rows, "arrays_checked": checked,
            "arrays_unchecked": unchecked, "errors": errors}


class ShardReader:
    """LRU cache of open shards. log_loads_every > 0 prints the running
    load/hit counts every Nth disk load. `loader(root, shard_id)` reads one
    shard (default: the native .h36x file; the dataset passes
    :func:`load_torch_shard` for a reference `.pt` store)."""

    def __init__(self, root, cache_size: int = 2, mmap: bool = True,
                 log_loads_every: int = 0, loader=None):
        self.root = Path(root)
        self.cache_size = cache_size
        self.mmap = mmap
        self.log_loads_every = log_loads_every
        self._loader = loader or (
            lambda root, sid: read_shard(shard_path(root, sid), mmap=self.mmap))
        self._cache: dict = {}
        self._order: list = []
        self.load_calls = 0
        self.hits = 0

    def get(self, shard_id: int) -> dict:
        if shard_id in self._cache:
            self.hits += 1
            self._order.remove(shard_id)
            self._order.append(shard_id)
            return self._cache[shard_id]
        # cache_size 0 means no caching: nothing to evict, nothing kept
        while self._order and len(self._order) >= self.cache_size:
            del self._cache[self._order.pop(0)]
        self.load_calls += 1
        shard = self._loader(self.root, shard_id)
        if self.cache_size > 0:
            self._cache[shard_id] = shard
            self._order.append(shard_id)
        if self.log_loads_every and self.load_calls % self.log_loads_every == 0:
            print(f"[shards] {self.load_calls} loads / {self.hits} hits "
                  f"(cache {self.cache_size}, shard {shard_id})", flush=True)
        return shard

    def stats(self) -> dict:
        return {"loads": self.load_calls, "hits": self.hits,
                "cache_size": self.cache_size}


def write_index(
    root,
    clips: List[dict],
    *,
    n_shards: int,
    n_clips: int,
    n_variants: int,
    aug_names: List[str],
    seq_len: int,
    frame_skip: int,
    feat_dtype: str,
    shuffle_seed: Optional[int] = None,
    shuffle_pool: Optional[int] = None,
) -> None:
    """Write index.json describing the shard set (atomic rename)."""
    payload = {
        "version": 1,
        "clips": clips,
        "n_shards": n_shards,
        "n_clips": n_clips,
        "n_variants": n_variants,
        "aug_names": aug_names,
        "seq_len": seq_len,
        "frame_skip": frame_skip,
        "feat_dtype": feat_dtype,
        "variants_grouped": True,
        "shuffle_seed": shuffle_seed,
        "shuffle_pool": shuffle_pool,
    }
    tmp = Path(root) / "index.json.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, Path(root) / "index.json")


def load_index(root) -> dict:
    """Load a store's index.json, or else a reference-format index.pt."""
    root = Path(root)
    path = root / "index.json"
    if path.exists():
        with open(path) as f:
            return json.load(f)
    tpath = root / "index.pt"
    if tpath.exists():
        return load_torch_index(tpath)
    raise FileNotFoundError(
        f"no index.json (or reference index.pt) under {root}; run the extract "
        "stage first.")


def merge_stores(parts, out_root, move: bool = True) -> dict:
    """Unify the part stores of a partitioned extraction (`--partition i/N`,
    one store per part) into one store under `out_root`: every part's shard
    files renumbered into one namespace and the clip indexes concatenated,
    no array read or rewritten. index.json and the shards come out equal,
    byte for byte, to h36x's merge of the same parts.

    Crash-safe order: (1) the shards are hard-linked into out_root (copied
    where the filesystem cannot link), the parts untouched; (2) the merged
    index is written (atomic rename), which makes out_root a store; (3)
    with `move` only then are the parts' shard files unlinked. A crash
    leaves intact parts and an index-less out_root, or a complete merged
    store and some stray source links, never a broken store.

    The parts' n_variants, aug_names, seq_len, frame_skip and feat_dtype
    must agree and no clip may repeat; out_root must hold no store. Returns
    the merged index."""
    import shutil

    parts = [Path(p) for p in parts]
    if not parts:
        raise ValueError("no part stores given")
    out_root = Path(out_root)
    out_root.mkdir(parents=True, exist_ok=True)
    leftovers = ([p.name for p in out_root.glob("shard_*.h36x")]
                 + [p.name for p in (out_root / "index.json",) if p.exists()])
    if leftovers:
        raise ValueError(f"output store {out_root} is not empty ({leftovers[:3]}...); "
                         "merge into a fresh directory")

    indexes = [load_index(p) for p in parts]
    first = indexes[0]
    for p, idx in zip(parts[1:], indexes[1:]):
        for key in ("n_variants", "aug_names", "seq_len", "frame_skip", "feat_dtype"):
            if idx[key] != first[key]:
                raise ValueError(f"part {p} disagrees on {key}: "
                                 f"{idx[key]!r} != {first[key]!r}")

    # everything checked before the filesystem is touched
    merged_clips: List[dict] = []
    links = []
    seen = set()
    offset = 0
    for part, idx in zip(parts, indexes):
        if idx.get("torch_format") or idx.get("n_shards") is None:
            raise ValueError(f"part {part} has a torch-format (or countless) index — "
                             "merge only native h36x part stores")
        for sid in range(idx["n_shards"]):
            src, dst = shard_path(part, sid), shard_path(out_root, offset + sid)
            if not src.exists():
                raise FileNotFoundError(f"part {part} is missing {src.name}")
            if src.resolve() == dst.resolve():
                raise ValueError(f"part {part} overlaps the output store")
            links.append((src, dst))
        for entry in idx["clips"]:
            key = (entry["subject"], entry["action"], entry["cam"], entry["start"])
            if key in seen:
                raise ValueError(f"clip {key} appears in more than one part")
            seen.add(key)
            merged_clips.append(dict(entry, shard_id=entry["shard_id"] + offset))
        offset += idx["n_shards"]

    for src, dst in links:
        try:
            os.link(src, dst)
        except OSError:
            shutil.copy2(src, dst)
    write_index(
        out_root, merged_clips, n_shards=offset, n_clips=len(merged_clips),
        n_variants=first["n_variants"], aug_names=first["aug_names"],
        seq_len=first["seq_len"], frame_skip=first["frame_skip"],
        feat_dtype=first["feat_dtype"], shuffle_seed=first.get("shuffle_seed"),
        shuffle_pool=first.get("shuffle_pool"))
    if move:
        for src, _ in links:
            os.unlink(src)
    return load_index(out_root)


# -- the reference's torch `.pt` stores -------------------------------------------


def load_torch_index(path) -> dict:
    """A reference-format index.pt as an index dict (`torch_format` set),
    read with torch.load(weights_only=True)."""
    idx = torch.load(path, map_location="cpu", weights_only=True)
    return {
        "version": 0,
        "clips": idx["clips"],
        "n_shards": idx.get("n_shards"),
        "n_clips": idx.get("n_clips"),
        "n_variants": idx["n_variants"],
        "aug_names": idx.get("aug_names", ["orig"]),
        "seq_len": idx.get("seq_len"),
        "frame_skip": idx.get("frame_skip"),
        "feat_dtype": idx.get("feat_dtype", "float32"),
        "variants_grouped": idx.get("variants_grouped", True),
        "torch_format": True,
    }


def load_torch_shard(root, shard_id: int) -> dict:
    """A reference-format shard_XXXXX.pt as read_shard's dict, its tensors
    as numpy arrays (a bfloat16 one as its bits)."""
    data = torch.load(Path(root) / f"shard_{shard_id:05d}.pt", map_location="cpu",
                      weights_only=True)
    out = {"meta": data.get("meta", []), "n_vars": data.get("n_vars", 1)}
    for k in ARRAY_KEYS:
        out[k] = host_array(data[k])
    return out
