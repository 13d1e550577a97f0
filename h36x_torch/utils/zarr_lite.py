"""zarr v2 arrays over an OCDBT store, and the JSON files of an orbax
checkpoint directory: enough to read and write what
`orbax.checkpoint.StandardCheckpointer` saves, without orbax, tensorstore
or zarr.

An orbax directory (`use_ocdbt: true`, `use_zarr3: false`) holds:

- the OCDBT store (:mod:`h36x_torch.utils.ocdbt`), with for each array
  leaf `<name>/.zarray` (JSON: shape, chunks, dtype, fill_value, order,
  compressor, ...) and one key per chunk, `<name>/<i>.<j>...` (`<name>/0`
  for a 0-d array), the chunk's bytes compressed as the `.zarray` says
  (orbax: zstd). `<name>` is the leaf's tree path joined by dots;
- `_METADATA`: the tree, `tree_metadata` mapping each leaf's path (as
  Python prints a tuple of str: `"('params', 'a')"`) to its `key_metadata`
  (key and key_type per level: 1 a sequence index, 2 a dict key) and its
  `value_metadata` (`value_type` "jax.Array", "np.ndarray" or "scalar" for
  arrays, "None" for an empty optax node such as `MaskedNode`, "Dict" for
  an empty dict; `write_shape` for an array);
- `_CHECKPOINT_METADATA` (handler name, timestamps), `_sharding` (per
  array, keyed by the base64 of its name, the JSON of its sharding) and
  `array_metadatas/process_<i>` (each array's write and chunk shapes).

A sharded save writes one chunk per shard: :func:`read_array` reassembles
any chunk grid. :func:`write_array` writes one chunk per array, compressed
as zstd frames of raw blocks (:func:`h36x_torch.utils.zstd.compress_raw`).

A tree here is nested dicts (dict keys) and lists (sequence indices) of
numpy arrays, with None for a "None" leaf and {} for a "Dict" leaf.
bfloat16 arrays are read as their uint16 bits (numpy has no bfloat16).
"""

from __future__ import annotations

import base64
import json
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from h36x_torch.utils import ocdbt, zstd

HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
# The port saves host arrays, so its leaves are "np.ndarray", the value type
# orbax gives numpy leaves: any host restores them, with or without a
# template ("jax.Array" would make a restore without one look for the
# device that `_sharding` names). `_sharding` still records that device.
VALUE_TYPE = "np.ndarray"
SINGLE_DEVICE = "SingleDeviceSharding"


def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        return np.dtype("<u2")
    try:
        return np.dtype(name)
    except TypeError as e:
        raise ValueError(f"zarr dtype {name!r} is not supported") from e


def _dtype_name(dt: np.dtype) -> str:
    dt = np.dtype(dt)
    return dt.str if dt.itemsize > 1 else "|" + dt.str[1:]


def _chunk_key(name: str, index, sep: str = ".") -> bytes:
    return f"{name}/{sep.join(map(str, index)) if len(index) else '0'}".encode()


def read_array(kv: Dict[bytes, bytes], name: str) -> np.ndarray:
    """The zarr v2 array `name` of the store's items `kv`, its chunks
    reassembled (one chunk or a grid of them)."""
    key = f"{name}/.zarray".encode()
    if key not in kv:
        raise KeyError(f"no zarr array {name!r} in the store")
    meta = json.loads(kv[key])
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}, only 2 is read")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not supported")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = _dtype(meta["dtype"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp} is not supported (zstd or null)")
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype=dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        ck = _chunk_key(name, index, sep)
        if ck not in kv:
            continue  # a chunk equal to the fill value may be left out
        raw = kv[ck]
        if comp is not None:
            raw = zstd.decompress(raw)
        if len(raw) != dtype.itemsize * int(np.prod(chunks, dtype=np.int64)):
            raise ValueError(f"{name}: chunk {index} holds {len(raw)} bytes, expected "
                             f"{dtype.itemsize * int(np.prod(chunks))}")
        block = np.frombuffer(raw, dtype=dtype).reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def write_array(kv: Dict[bytes, bytes], name: str, arr: np.ndarray) -> None:
    """Add array `name` to `kv`: its `.zarray` (orbax's fields, one chunk
    the array's shape, compressor zstd) and its one chunk."""
    arr = np.asarray(arr, order="C")  # (ascontiguousarray would make a 0-d array 1-d)
    meta = {"chunks": list(arr.shape), "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": _dtype_name(arr.dtype),
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(arr.shape), "zarr_format": 2}
    kv[f"{name}/.zarray".encode()] = json.dumps(meta, sort_keys=True,
                                                separators=(",", ":")).encode()
    kv[_chunk_key(name, (0,) * arr.ndim)] = zstd.compress_raw(arr.tobytes())


def _flatten(tree, path=(), key_types=()) -> List[Tuple[tuple, tuple, object]]:
    """(path, key types, leaf) of every leaf: arrays, None and {}."""
    if isinstance(tree, dict) and tree:
        out = []
        for k, v in tree.items():
            out += _flatten(v, path + (str(k),), key_types + (2,))
        return out
    if isinstance(tree, (list, tuple)) and len(tree):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, path + (str(i),), key_types + (1,))
        return out
    return [(path, key_types, tree)]


def write_tree(directory, tree, device: str = "cpu") -> int:
    """Write `tree` as an orbax StandardCheckpointer directory at
    `directory` (which must not exist yet): the OCDBT store with one zarr
    array per array leaf, `_METADATA`, `_sharding` (each array on `device`),
    `array_metadatas/process_0` and `_CHECKPOINT_METADATA` last. Returns
    the bytes of the store."""
    start = time.time_ns()
    directory = Path(directory)
    directory.mkdir(parents=True)
    kv: Dict[bytes, bytes] = {}
    tree_meta, sharding, arrays = {}, {}, []
    for path, key_types, leaf in _flatten(tree):
        keys = [{"key": k, "key_type": t} for k, t in zip(path, key_types)]
        if leaf is None or isinstance(leaf, dict):
            value = {"value_type": "None" if leaf is None else "Dict",
                     "skip_deserialize": True}
        else:
            arr = np.asarray(leaf)
            name = ".".join(path)
            write_array(kv, name, arr)
            value = {"value_type": VALUE_TYPE, "skip_deserialize": False,
                     "write_shape": list(arr.shape)}
            sharding[base64.b64encode(name.encode()).decode()] = json.dumps(
                {"sharding_type": SINGLE_DEVICE, "device_str": device})
            arrays.append({"array_metadata": {
                "param_name": name, "write_shape": list(arr.shape),
                "chunk_shape": list(arr.shape), "ext_metadata": None}})
        tree_meta[str(tuple(path))] = {"key_metadata": keys, "value_metadata": value}
    nbytes = ocdbt.write_store(directory, kv)
    _write_json(directory / "_METADATA", {
        "tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
    _write_json(directory / "_sharding", sharding)
    _write_json(directory / "array_metadatas" / "process_0", {"array_metadatas": arrays})
    _write_json(directory / "_CHECKPOINT_METADATA", {
        "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": start, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}})
    return nbytes


def _write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))


def read_metadata(directory) -> dict:
    """`_METADATA` of an orbax directory, refusing layouts this reader does
    not know (zarr3, no OCDBT)."""
    path = Path(directory) / "_METADATA"
    if not path.is_file():
        raise FileNotFoundError(f"{directory}: no _METADATA (not an orbax checkpoint)")
    meta = json.loads(path.read_text())
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{directory}: use_ocdbt={meta.get('use_ocdbt')}, "
                         f"use_zarr3={meta.get('use_zarr3')}; only OCDBT with zarr v2 "
                         "(orbax's default) is read")
    return meta


def read_tree(directory, store: "ocdbt.Store" = None):
    """The tree of the orbax directory `directory`: nested dicts and lists
    of numpy arrays (None and {} for empty optax nodes and dicts), every
    array read from the OCDBT store (`store`, when given, is used and its
    `checked` count grows)."""
    meta = read_metadata(directory)
    store = store if store is not None else ocdbt.Store(directory)
    kv = store.read_all()
    root: dict = {}
    seqs = []
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        vt = value.get("value_type")
        path = [k["key"] for k in keys]
        if vt in ARRAY_TYPES:
            leaf = read_array(kv, ".".join(path))
        elif vt == "None":
            leaf = None
        elif vt == "Dict":
            leaf = {}
        else:
            raise ValueError(f"{directory}: leaf {path} of value type {vt!r} is not read")
        node = root
        for i, k in enumerate(keys[:-1]):
            node = node.setdefault(str(k["key"]), {})
            if keys[i + 1]["key_type"] == 1:
                seqs.append(node)
        if not keys:
            return leaf
        node[str(keys[-1]["key"])] = leaf
    return _sequences(root, {id(s) for s in seqs})


def _sequences(node, seq_ids):
    """Dicts indexed by sequence keys -> lists, in index order."""
    if not isinstance(node, dict):
        return node
    out = {k: _sequences(v, seq_ids) for k, v in node.items()}
    if id(node) in seq_ids:
        return [out[k] for k in sorted(out, key=int)]
    return out
