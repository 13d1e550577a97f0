"""Checkpoints (counterpart of h36x/train/checkpoint.py).

Reads the params of h36x's msgpack checkpoints — a full TrainState blob
(its `params` entry) or a bare params blob — without jax or the `msgpack`
package. Writes the port's params blob, or a full training checkpoint
{params, opt_state, step} (:func:`save_checkpoint`) in the tree that
`flax.serialization.to_bytes` gives for h36x's TrainState, next to the
same JSON manifest, and resumes either package's full checkpoint
(:func:`load_checkpoint`): a `last` written by one package resumes in the
other. Orbax checkpoint directories come with a later slice of the port.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from h36x_torch.models.phd import _nest, params_from_flax, params_to_flax
from h36x_torch.utils import msgpack_lite

_ORBAX_LATER = ("orbax checkpoint directories are not readable by h36x_torch "
                "yet (they come with the port's checkpoint slice); save a "
                ".msgpack checkpoint with h36x instead")


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


def load_params_raw(path) -> dict:
    """The params of a msgpack checkpoint as a flax tree of numpy arrays:
    the `params` entry of a full TrainState blob, or a bare params blob."""
    path = Path(path)
    if path.is_dir() or (not path.exists()
                         and _orbax_dir(path.parent, path.name) is not None):
        raise NotImplementedError(f"{path}: {_ORBAX_LATER}")
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
    return _match_params(path, params_from_flax(load_params_raw(path)), state_dict)


def _match_params(path, got: dict, state_dict: dict) -> dict:
    missing = sorted(set(state_dict) - set(got))
    extra = sorted(set(got) - set(state_dict))
    if missing or extra:
        raise ValueError(f"{path}: params do not match the model: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    bad = [f"{k}: checkpoint {tuple(got[k].shape)} vs model "
           f"{tuple(state_dict[k].shape)}"
           for k in state_dict if tuple(got[k].shape) != tuple(state_dict[k].shape)]
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


def opt_state_tree(model, optimizer) -> dict:
    """The optimizer's state in the tree `flax.serialization.to_bytes` gives
    for h36x's optax state (h36x/train/state.py::make_optimizer):
    inject_hyperparams(adamw) = {count, hyperparams, hyperparams_states,
    inner_state: {"0": scale_by_adam {count, mu, nu}, "1": {}, "2": {}}},
    wrapped, when a module is frozen, in multi_transform's
    {inner_states: {trainable: {inner_state: ...}, frozen: {inner_state:
    {}}}}. A frozen leaf of mu/nu is an empty map (optax's MaskedNode);
    counts are int32 and hyper-parameters float32 0-d arrays."""
    trainable = {id(p) for p in optimizer.param_groups[0]["params"]}
    named = dict(model.named_parameters())
    mu = {n: _f32(optimizer.state[p]["mu"]) if id(p) in trainable else {}
          for n, p in named.items()}
    nu = {n: _f32(optimizer.state[p]["nu"]) if id(p) in trainable else {}
          for n, p in named.items()}
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
        "params": params_to_flax(model.state_dict()),
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


def load_checkpoint(directory, name: str, model, optimizer) -> dict:
    """Restore checkpoint <directory>/<name>.msgpack — written by the port
    or by h36x — into `model` and `optimizer` (an
    :class:`h36x_torch.train.state.AdamW` of the same phase), in place:
    params, AdamW's mu, nu and count and its hyper-parameters (the learning
    rate among them). Returns the manifest, its "step" the blob's. A layout
    that does not fit the optimizer's phase (a module trainable here but
    frozen there, or the other way) raises ValueError naming what is
    missing, as h36x's `from_bytes` refuses it."""
    directory = Path(directory)
    path = directory / f"{name}.msgpack"
    manifest_path = directory / f"{name}.json"
    if manifest_path.exists():
        with open(manifest_path) as f:
            backend = json.load(f).get("backend", "msgpack")
        if backend == "orbax":
            raise NotImplementedError(f"{directory}/{name}: {_ORBAX_LATER}")
    if not path.exists():
        if (directory / name).is_dir():
            raise NotImplementedError(f"{directory}/{name}: {_ORBAX_LATER}")
        raise FileNotFoundError(f"no checkpoint '{name}' under {directory} "
                                f"(no {name}.msgpack)")
    raw = msgpack_lite.unpackb(path.read_bytes())
    if not (isinstance(raw, dict) and {"params", "opt_state", "step"} <= set(raw)):
        raise ValueError(f"{path}: not a full training checkpoint (params, "
                         "opt_state, step); --init-from takes a params blob")
    params = _match_params(path, params_from_flax(raw["params"]), model.state_dict())
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
            if not isinstance(leaf, np.ndarray) or leaf.shape != tuple(p.shape):
                raise ValueError(f"{what}: opt_state has no {key} of {n} "
                                 f"(shape {tuple(p.shape)}; a checkpoint of "
                                 "another phase's optimizer?)")
            moments[(id(p), key)] = leaf
    for k, key in OPTAX_HYPER:
        if k not in hyper:
            raise ValueError(f"{what}: opt_state has no hyperparams/{k}")
    with torch.no_grad():
        state = model.state_dict()
        for n, value in params.items():
            state[n].copy_(value)
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
