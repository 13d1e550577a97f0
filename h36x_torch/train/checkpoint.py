"""Checkpoints (counterpart of h36x/train/checkpoint.py).

Both of h36x's backends, without jax, flax, msgpack, orbax or
tensorstore:

- **msgpack**: a full TrainState blob {params, opt_state, step} in the
  tree `flax.serialization.to_bytes` gives for h36x's TrainState
  (:func:`save_checkpoint`), or a bare params blob (:func:`save_params`),
  next to the JSON manifest <name>.json;
- **orbax** (`--ckpt-backend orbax`, :func:`save_checkpoint_orbax`): the
  directory `orbax.checkpoint.StandardCheckpointer` writes for that
  TrainState (OCDBT store, zarr arrays, its JSON files:
  :mod:`h36x_torch.utils.zarr_lite`), in h36x's slot scheme
  <name>.0 / <name>.1 with the manifest's "dir" naming the live one.

:func:`load_checkpoint` resumes either package's full checkpoint of
either backend (the manifest's "backend" decides, as h36x's does), and
:func:`load_params_raw` / :func:`load_params_only` read the params of any
of them, an `outdir/last`-style reference to a slotted orbax save
included. In memory the optimizer state is always the msgpack tree
(:func:`opt_state_tree`); an orbax tree differs only where optax's
structure shows: the AdamW chain's `inner_state` is a sequence, empty
optax nodes (`MaskedNode`, `EmptyState`) are None and
`hyperparams_states` an empty dict.

A model trained over a local mesh saves replica 0's params, the model
itself: the data replicas share or copy its params, and a model axis over
local devices keeps full params on the first one, its slices taken from
them on each device (:mod:`h36x_torch.parallel.tensor`), so either backend
writes h36x's bytes and msgpack may save it, as in h36x. A
tensor-parallel model over processes saves its full arrays, gathered over
its model group (every rank calls the save; rank 0 writes one process's
OCDBT layout), and loads them whole, keeping its slices. This departs from h36x, whose multi-process orbax saves write one
b-tree per process; both layouts are valid orbax directories, and both
packages read both.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from h36x_torch.models.phd import _nest, params_from_flax, params_to_flax
from h36x_torch.parallel.distributed import is_main_process
from h36x_torch.utils import msgpack_lite, ocdbt, zarr_lite

MANIFEST = "manifest.json"  # h36x's name (h36x/train/checkpoint.py)


def _orbax_dir(directory: Path, name: str) -> Optional[Path]:
    """The live orbax directory for checkpoint `name` (the manifest's "dir"
    slot pointer, or a legacy un-slotted <name>/), else None."""
    manifest_path = directory / f"{name}.json"
    if manifest_path.exists():
        with open(manifest_path) as f:
            slot = json.load(f).get("dir")
        if slot is not None:
            return directory / slot if (directory / slot).is_dir() else None
    if (directory / name).is_dir():
        return directory / name
    return None


def checkpoint_ref_exists(path) -> bool:
    """True when `path` names a real file/dir or an `outdir/last`-style
    reference to a slotted orbax save."""
    path = Path(path)
    return path.exists() or _orbax_dir(path.parent, path.name) is not None


def load_recorded_config(model_path) -> dict:
    """Full TrainConfig dict recorded in the manifest next to `model_path`
    (`outdir/best.msgpack` -> `outdir/best.json`; `outdir/last` ->
    `outdir/last.json`; slot dir `outdir/last.0` -> `outdir/last.json`).
    {} when there is none."""
    if not str(model_path):
        return {}
    p = Path(model_path)
    candidates = [p.with_suffix(".json") if p.suffix == ".msgpack"
                  else p.parent / f"{p.name}.json"]
    stem, dot, slot = p.name.rpartition(".")
    if dot and slot.isdigit():
        candidates.append(p.parent / f"{stem}.json")
    for mpath in candidates:
        if mpath.exists():
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
            except (json.JSONDecodeError, OSError):
                continue
            cfg = manifest.get("config", {})
            if isinstance(cfg, dict):
                return dict(cfg)
    return {}


def load_recorded_model_config(model_path) -> dict:
    """The `model` section of the recorded config — the architecture the
    checkpoint was trained with."""
    model_cfg = load_recorded_config(model_path).get("model", {})
    return dict(model_cfg) if isinstance(model_cfg, dict) else {}


def _from_orbax(node):
    """An orbax tree (:func:`h36x_torch.utils.zarr_lite.read_tree`) in the
    msgpack tree's form: sequences as {"0": ...}, None as {}."""
    if node is None:
        return {}
    if isinstance(node, list):
        return {str(i): _from_orbax(v) for i, v in enumerate(node)}
    if isinstance(node, dict):
        return {k: _from_orbax(v) for k, v in node.items()}
    return node


def _to_orbax(node, key: str = ""):
    """The msgpack form of an optax state -> the tree orbax saves for it:
    a map indexed "0".."n-1" (a tuple of transforms) a sequence, an empty
    map None (optax's MaskedNode and EmptyState) except
    `hyperparams_states`, an empty dict."""
    if isinstance(node, dict):
        if not node:
            return {} if key == "hyperparams_states" else None
        if sorted(node) == [str(i) for i in range(len(node))]:
            return [_to_orbax(node[str(i)], str(i)) for i in range(len(node))]
        return {k: _to_orbax(v, k) for k, v in node.items()}
    return node


def read_orbax(path) -> dict:
    """The tree of the orbax directory `path`, in the msgpack tree's form
    (:func:`_from_orbax`)."""
    return _from_orbax(zarr_lite.read_tree(path))


def inspect_orbax(path) -> dict:
    """Read every array of the orbax directory `path`, checking every
    manifest's and node's CRC-32C and every chunk's zstd frame: {"arrays":
    the arrays read, "bytes": their bytes, "crc_checked": the manifests and
    nodes whose CRC held}. A corrupt directory raises."""
    store = ocdbt.Store(path)
    tree = zarr_lite.read_tree(path, store)
    arrays = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        elif node is not None:
            arrays.append(node)

    walk(tree)
    return {"arrays": len(arrays), "bytes": sum(a.nbytes for a in arrays),
            "crc_checked": store.checked}


def load_params_raw(path) -> dict:
    """The params of a checkpoint as a flax tree of numpy arrays: the
    `params` entry of a full TrainState (msgpack blob or orbax directory,
    `outdir/last` resolving to its live slot), or a bare params blob."""
    path = Path(path)
    if not path.exists():
        resolved = _orbax_dir(path.parent, path.name)
        if resolved is not None:
            path = resolved
    if path.is_dir():
        raw = read_orbax(path)
        if isinstance(raw, dict) and "params" in raw:
            raw = raw["params"]
        if not isinstance(raw, dict):
            raise ValueError(f"{path}: not a params checkpoint")
        return raw
    raw = msgpack_lite.unpackb(path.read_bytes())
    if isinstance(raw, dict) and "params" in raw and "opt_state" in raw:
        raw = raw["params"]
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: not a params checkpoint "
                         f"(top level is {type(raw).__name__})")
    return raw


def load_params_only(path, state_dict: dict) -> dict:
    """Params of the checkpoint at `path` as a `state_dict` of CPU tensors,
    held against `state_dict` (the model's): every key must be there, no
    other, and every leaf must have the model's shape."""
    shapes = {k: tuple(v.shape) for k, v in state_dict.items()}
    return _match_params(path, params_from_flax(load_params_raw(path)), shapes)


def _match_params(path, got: dict, shapes: dict) -> dict:
    missing = sorted(set(shapes) - set(got))
    extra = sorted(set(got) - set(shapes))
    if missing or extra:
        raise ValueError(f"{path}: params do not match the model: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    bad = [f"{k}: checkpoint {tuple(got[k].shape)} vs model {shapes[k]}"
           for k in shapes if tuple(got[k].shape) != shapes[k]]
    if bad:
        raise ValueError(f"{path}: param shapes do not match the model:\n  "
                         + "\n  ".join(bad))
    return got


def _write(directory, name: str, blob: bytes, manifest: dict) -> Path:
    """<directory>/<name>.msgpack then <directory>/<name>.json (manifest +
    sha256 + nbytes of the blob), each by atomic rename: the manifest
    commits after the blob it describes."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    data_path = directory / f"{name}.msgpack"
    tmp = f"{data_path}.tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, data_path)
    manifest = {**manifest, "sha256": hashlib.sha256(blob).hexdigest(),
                "nbytes": len(blob)}
    mpath = directory / f"{name}.json"
    tmp = f"{mpath}.tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, mpath)
    return data_path


def save_params(directory, name: str, state_dict: dict,
                config: Optional[dict] = None) -> Path:
    """Write <directory>/<name>.msgpack (a flax-format bare params blob) and
    <directory>/<name>.json (config, sha256, nbytes)."""
    blob = msgpack_lite.packb(params_to_flax(state_dict))
    return _write(directory, name, blob, {"config": config or {}})


# AdamW's hyper-parameters under optax.inject_hyperparams(optax.adamw)'s
# names, in its order; eps_root is optax's and 0 here
OPTAX_HYPER = (("learning_rate", "lr"), ("b1", "b1"), ("b2", "b2"),
               ("eps", "eps"), ("eps_root", None), ("weight_decay", "weight_decay"))


def _f32(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def _full(model, name: str, t: torch.Tensor) -> torch.Tensor:
    """Tensor `t` of param `name` at its full shape: gathered over the model
    group of a tensor-parallel model (a collective), else `t`."""
    return model.tp.gather(name, t) if model.tp is not None else t


def _shapes(model) -> dict:
    """The full shape of every param (a tensor-parallel model holds
    slices)."""
    tp = model.tp
    return {n: tp.full_shape(n, p.shape) if tp is not None else tuple(p.shape)
            for n, p in model.named_parameters()}


def params_tree(model) -> dict:
    """The model's params as a flax tree of full numpy arrays."""
    return params_to_flax({n: _full(model, n, p) for n, p in model.state_dict().items()})


def opt_state_tree(model, optimizer) -> dict:
    """The optimizer's state in the tree `flax.serialization.to_bytes` gives
    for h36x's optax state (h36x/train/state.py::make_optimizer):
    inject_hyperparams(adamw) = {count, hyperparams, hyperparams_states,
    inner_state: {"0": scale_by_adam {count, mu, nu}, "1": {}, "2": {}}},
    wrapped, when a module is frozen, in multi_transform's
    {inner_states: {trainable: {inner_state: ...}, frozen: {inner_state:
    {}}}}. A frozen leaf of mu/nu is an empty map (optax's MaskedNode);
    counts are int32 and hyper-parameters float32 0-d arrays. A
    tensor-parallel model's moments are gathered to full shape."""
    trainable = {id(p) for p in optimizer.param_groups[0]["params"]}
    named = dict(model.named_parameters())
    mu = {n: _f32(_full(model, n, optimizer.state[p]["mu"])) if id(p) in trainable
          else {} for n, p in named.items()}
    nu = {n: _f32(_full(model, n, optimizer.state[p]["nu"])) if id(p) in trainable
          else {} for n, p in named.items()}
    count = np.asarray(optimizer.count.cpu().numpy(), dtype=np.int32)
    hyper = {name: (_f32(optimizer.hyper[key]) if key else np.zeros((), np.float32))
             for name, key in OPTAX_HYPER}
    inject = {"count": count, "hyperparams": hyper, "hyperparams_states": {},
              "inner_state": {"0": {"count": count.copy(), "mu": _nest(mu),
                                    "nu": _nest(nu)}, "1": {}, "2": {}}}
    if len(trainable) == len(named):
        return inject
    return {"inner_states": {"trainable": {"inner_state": inject},
                             "frozen": {"inner_state": {}}}}


def save_checkpoint(directory, name: str, model, optimizer, epoch: int,
                    best_val: float, step: int, config: Optional[dict] = None,
                    extra: Optional[dict] = None) -> Path:
    """Write <directory>/<name>.msgpack, h36x's TrainState blob {params,
    opt_state, step} (params in flax layout, opt_state as
    :func:`opt_state_tree`, step an int32 0-d array), and the manifest
    <name>.json: epoch, best_val, step, config, sha256, nbytes and the
    `extra` entries."""
    blob = msgpack_lite.packb({
        "params": params_tree(model),
        "opt_state": opt_state_tree(model, optimizer),
        "step": np.asarray(step, dtype=np.int32),
    })
    return _write(directory, name, blob,
                  {"epoch": int(epoch), "best_val": float(best_val),
                   "step": int(step), "config": config or {}, **(extra or {})})


def _read_manifest(directory: Path, name: str) -> dict:
    """The manifest of checkpoint `name`; without one (a save that crashed
    before committing it), neutral counters as h36x restores them: the
    schedule restarts at epoch 0."""
    path = directory / f"{name}.json"
    if path.exists():
        with open(path) as f:
            return json.load(f)
    print(f"WARNING: checkpoint '{name}' has no manifest under {directory}; "
          "restarting the schedule at epoch 0")
    return {"epoch": -1, "step": 0, "best_val": float("inf"),
            "manifest_missing": True}


def _subtree(tree, path: tuple, what: str):
    """tree[path[0]][path[1]]...; a key that is not there raises ValueError
    naming it."""
    node = tree
    for i, key in enumerate(path):
        if not isinstance(node, dict) or key not in node:
            raise ValueError(f"{what}: opt_state has no {'/'.join(path[:i + 1])} "
                             "(a checkpoint of another phase's optimizer?)")
        node = node[key]
    return node


def _leaf(tree: dict, name: str):
    """The leaf of a flax-layout tree at a dotted param name, None when it
    is not there."""
    node = tree
    for part in name.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _read_state(directory: Path, name: str):
    """(the raw TrainState tree in the msgpack form, its path) of checkpoint
    `name`, by h36x's rules: the manifest's "backend" decides, and a
    backend whose files are gone raises rather than falling back to a
    stale file of the other."""
    manifest_path = directory / f"{name}.json"
    msgpack = directory / f"{name}.msgpack"
    if manifest_path.exists():
        with open(manifest_path) as f:
            backend = json.load(f).get("backend", "msgpack")
        if backend == "orbax":
            slot = _orbax_dir(directory, name)
            if slot is None:
                raise FileNotFoundError(
                    f"manifest {manifest_path} records backend=orbax but no orbax "
                    f"checkpoint directory for '{name}' exists under {directory} "
                    "(crashed save or partial sync?); refusing to fall back to a "
                    "stale msgpack file")
            return read_orbax(slot), slot
        if not msgpack.exists():
            raise FileNotFoundError(
                f"manifest {manifest_path} records backend=msgpack but "
                f"{name}.msgpack is missing under {directory} (deleted or partial "
                "sync?); refusing to fall back to a stale orbax directory")
    if msgpack.exists():
        return msgpack_lite.unpackb(msgpack.read_bytes()), msgpack
    if (directory / name).is_dir():
        return read_orbax(directory / name), directory / name
    raise FileNotFoundError(f"no checkpoint '{name}' under {directory} "
                            f"(neither {name}.msgpack nor an orbax {name}/ directory)")


def load_checkpoint(directory, name: str, model, optimizer) -> dict:
    """Restore checkpoint `name` under `directory` — a msgpack blob or an
    orbax directory, written by the port or by h36x (:func:`_read_state`)
    — into `model` and `optimizer` (an :class:`h36x_torch.train.state.AdamW`
    of the same phase), in place: params, AdamW's mu, nu and count and its
    hyper-parameters (the learning rate among them). Returns the manifest,
    its "step" the checkpoint's. A layout that does not fit the optimizer's
    phase (a module trainable here but frozen there, or the other way)
    raises ValueError naming what is missing, as h36x's `from_bytes`
    refuses it. A tensor-parallel model reads the full arrays and keeps its
    slices."""
    directory = Path(directory)
    raw, path = _read_state(directory, name)
    if not (isinstance(raw, dict) and {"params", "opt_state", "step"} <= set(raw)):
        raise ValueError(f"{path}: not a full training checkpoint (params, "
                         "opt_state, step); --init-from takes a params blob")
    tp = model.tp
    shapes = _shapes(model)
    params = _match_params(path, params_from_flax(raw["params"]), shapes)
    trainable = {id(p) for p in optimizer.param_groups[0]["params"]}
    named = dict(model.named_parameters())
    what = str(path)
    inject = raw["opt_state"]
    if len(trainable) != len(named):
        _subtree(inject, ("inner_states", "frozen", "inner_state"), what)
        inject = _subtree(inject, ("inner_states", "trainable", "inner_state"), what)
    elif "inner_states" in inject:
        raise ValueError(f"{what}: opt_state is multi_transform's (modules frozen "
                         "there), but this optimizer trains every module")
    adam = _subtree(inject, ("inner_state", "0"), what)
    hyper = _subtree(inject, ("hyperparams",), what)
    moments = {}
    for n, p in named.items():
        for key in ("mu", "nu"):
            leaf = _leaf(_subtree(adam, (key,), what), n)
            if leaf is None:
                raise ValueError(f"{what}: opt_state has no {key} leaf for {n}")
            if id(p) not in trainable:
                if not (isinstance(leaf, dict) and not leaf):
                    raise ValueError(f"{what}: opt_state holds {key} of {n}, which "
                                     "this optimizer freezes")
                continue
            if not isinstance(leaf, np.ndarray) or leaf.shape != shapes[n]:
                raise ValueError(f"{what}: opt_state has no {key} of {n} "
                                 f"(shape {shapes[n]}; a checkpoint of "
                                 "another phase's optimizer?)")
            moments[(id(p), key)] = leaf if tp is None else tp.local(n, leaf)
    for k, key in OPTAX_HYPER:
        if k not in hyper:
            raise ValueError(f"{what}: opt_state has no hyperparams/{k}")
    with torch.no_grad():
        state = model.state_dict()
        for n, value in params.items():
            state[n].copy_(value if tp is None else tp.local(n, value))
        for p in optimizer.param_groups[0]["params"]:
            for key in ("mu", "nu"):
                optimizer.state[p][key].copy_(torch.from_numpy(
                    np.array(moments[(id(p), key)], copy=True)))
        optimizer.count.fill_(int(_subtree(adam, ("count",), what)))
        for k, key in OPTAX_HYPER:
            if key:
                optimizer.hyper[key].fill_(float(hyper[k]))
                optimizer.param_groups[0][key] = float(hyper[k])
    manifest = _read_manifest(directory, name)
    manifest["step"] = int(raw["step"])
    return manifest


_slot_counters: dict = {}  # (directory, name) -> saves issued this process


def save_checkpoint_orbax(directory, name: str, model, optimizer, epoch: int,
                          best_val: float, step: int, config: Optional[dict] = None,
                          extra: Optional[dict] = None) -> Path:
    """h36x's orbax backend: write <directory>/<name>.<slot>/, the
    directory orbax's StandardCheckpointer writes for h36x's TrainState
    {params, opt_state, step}, then the manifest <name>.json with
    "backend": "orbax" and "dir": the slot.

    Saves alternate between the slots <name>.0 and <name>.1 (h36x's
    crash-atomic scheme): a per-(directory, name) counter of this process,
    its first value taken from the live slot on disk so that the first
    save never replaces it. The directory is written under a temporary name
    and renamed into its slot; the manifest is swapped after it.

    Every process calls it, as h36x's collective save; a tensor-parallel
    model gathers its arrays over its model group here (module docstring),
    and rank 0 alone writes."""
    directory = Path(directory)
    key = (str(directory.absolute()), name)
    if key not in _slot_counters:
        start = 0
        live = _orbax_dir(directory, name)
        if live is not None and live.name.rsplit(".", 1)[-1] in ("0", "1"):
            start = 1 - int(live.name.rsplit(".", 1)[-1])
        _slot_counters[key] = start
    slot = _slot_counters[key] % 2
    _slot_counters[key] += 1
    slot_name = f"{name}.{slot}"
    path = (directory / slot_name).absolute()
    main = is_main_process()
    if not main and (model.tp is None or not model.tp.collective):
        return path  # nothing to gather: rank 0 holds every array
    tree = {"params": params_tree(model),
            "opt_state": _to_orbax(opt_state_tree(model, optimizer)),
            "step": np.asarray(step, dtype=np.int32)}
    if not main:
        return path
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"{slot_name}.orbax-checkpoint-tmp-{time.time_ns()}"
    zarr_lite.write_tree(tmp, tree, device=str(next(model.parameters()).device))
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)
    manifest = {"epoch": int(epoch), "best_val": float(best_val), "step": int(step),
                "config": config or {}, "backend": "orbax", "dir": slot_name,
                **(extra or {})}
    mpath = directory / f"{name}.json"
    tmp_m = f"{mpath}.tmp"
    with open(tmp_m, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp_m, mpath)
    return path
