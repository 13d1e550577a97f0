"""Checkpoints (counterpart of h36x/train/checkpoint.py).

Reads the params of h36x's msgpack checkpoints — a full TrainState blob
(its `params` entry) or a bare params blob — without jax or the `msgpack`
package. Writes the port's params blob, or a full training checkpoint
{params, opt_state, step} (:func:`save_checkpoint`), with params in flax's
format next to the same JSON manifest, so either package can open the
params the other wrote. Orbax checkpoint directories and resuming from a
checkpoint's optimizer state come with later slices of the port.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Optional

from h36x_torch.models.phd import params_from_flax, params_to_flax
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
    got = params_from_flax(load_params_raw(path))
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


def opt_state_tree(model, optimizer) -> dict:
    """The optimizer's state in the port's own layout: {"lr", "count",
    "mu", "nu"} with mu/nu (AdamW's first and second moments,
    :class:`h36x_torch.train.state.AdamW`) as flax-layout trees of the
    trainable parameters that have state."""
    names = {id(p): n for n, p in model.named_parameters()}
    mu, nu, count = {}, {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "mu" not in st:
                continue
            mu[names[id(p)]] = st["mu"]
            nu[names[id(p)]] = st["nu"]
            count = int(st["count"])
    return {"lr": float(optimizer.param_groups[0]["lr"]), "count": count,
            "mu": params_to_flax(mu), "nu": params_to_flax(nu)}


def save_checkpoint(directory, name: str, model, optimizer, epoch: int,
                    best_val: float, step: int, config: Optional[dict] = None,
                    extra: Optional[dict] = None) -> Path:
    """Write <directory>/<name>.msgpack, a {params, opt_state, step} blob
    (params in flax layout, so h36x's `load_params_raw` reads them;
    opt_state in the port's layout, :func:`opt_state_tree`), and the
    manifest <name>.json: epoch, best_val, step, config, sha256, nbytes and
    the `extra` entries."""
    blob = msgpack_lite.packb({
        "params": params_to_flax(model.state_dict()),
        "opt_state": opt_state_tree(model, optimizer),
        "step": int(step),
    })
    return _write(directory, name, blob,
                  {"epoch": int(epoch), "best_val": float(best_val),
                   "step": int(step), "config": config or {}, **(extra or {})})
