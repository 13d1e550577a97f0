"""CLI: convert artifacts between the reference (torch) and h36x formats
(counterpart of h36x/cli/convert.py; the stores and checkpoints it writes
are h36x's, byte for byte).

Two migrations for users coming from the reference pipeline:

  --torch-shards SRC --out DST : rewrite a reference shard store
    (shard_XXXXX.pt + index.pt) into the h36x raw shard format +
    index.json, which training reads without deserializing.

  --torch-ckpt best.pt --out dir/ [--name best] : convert a reference
    training checkpoint into a params-only .msgpack + manifest, loadable by
    --init-from and by the results / predict / parity --ckpt CLIs.

And two exports back to the reference's formats:

  --to-torch-shards SRC --out DST : an h36x feature store -> the
    reference's torch store (shard_XXXXX.pt + index.pt, loadable with
    weights_only=True); array bytes pass through unchanged.

  --to-torch-ckpt CKPT --out best.pt : an h36x checkpoint (a msgpack
    full training state or params-only, or an orbax directory / an
    `outdir/best` reference to one) -> the reference's state_dict, which
    its model loads with strict=True.

    python -m h36x_torch.cli.convert --torch-ckpt best.pt --out runs
"""

import argparse
import json
import os
from pathlib import Path

import numpy as np


def convert_shard_store(src: str, dst: str) -> int:
    from h36x_torch.data.shards import (
        ARRAY_KEYS,
        load_torch_index,
        load_torch_shard,
        shard_path,
        write_index,
        write_shard,
    )

    src_p, dst_p = Path(src), Path(dst)
    dst_p.mkdir(parents=True, exist_ok=True)
    index = load_torch_index(src_p / "index.pt")
    n_shards = index["n_shards"]
    if n_shards is None:
        n_shards = 1 + max(c["shard_id"] for c in index["clips"])
    for sid in range(n_shards):
        shard = load_torch_shard(src_p, sid)
        arrays = {k: np.asarray(shard[k]) for k in ARRAY_KEYS}
        write_shard(shard_path(dst_p, sid), arrays, shard["meta"], shard["n_vars"])
        print(f"shard {sid + 1}/{n_shards} converted", flush=True)
    write_index(
        dst_p,
        index["clips"],
        n_shards=n_shards,
        n_clips=index.get("n_clips") or len(index["clips"]),
        n_variants=index["n_variants"],
        aug_names=index.get("aug_names", ["orig"]),
        seq_len=index.get("seq_len"),
        frame_skip=index.get("frame_skip"),
        feat_dtype=index.get("feat_dtype", "float32"),
    )
    return n_shards


def convert_checkpoint(torch_ckpt: str, out_dir: str, name: str = "best",
                       groups: int = 32, regressor_iters: int = 3) -> Path:
    from h36x_torch.models.torch_import import infer_model_config, load_torch_phd
    from h36x_torch.utils import msgpack_lite

    params = load_torch_phd(torch_ckpt)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    data_path = out / f"{name}.msgpack"
    with open(data_path, "wb") as f:
        f.write(msgpack_lite.packb(params))
    # the architecture, so the consumer CLIs resolve it from the manifest:
    # the shape-visible fields from the params, groups and regressor_iters
    # (in no shape) from the flags, whose defaults are the reference's
    model_cfg = infer_model_config(params)
    model_cfg["groups"] = groups
    model_cfg["regressor_iters"] = regressor_iters
    with open(out / f"{name}.json", "w") as f:
        json.dump({"converted_from": os.path.abspath(torch_ckpt),
                   "format": "params-only",
                   "model_config_inferred_from_shapes": True,
                   "config": {"model": model_cfg}}, f, indent=2)
    return data_path


def export_shard_store(src: str, dst: str) -> int:
    """h36x store -> the reference's torch store: the inverse of
    convert_shard_store; array bytes and meta / index records unchanged."""
    import torch

    from h36x_torch.data.shards import ARRAY_KEYS, load_index, read_shard, shard_path

    src_p, dst_p = Path(src), Path(dst)
    dst_p.mkdir(parents=True, exist_ok=True)
    index = load_index(src_p)
    n_shards = index["n_shards"]
    for sid in range(n_shards):
        shard = read_shard(shard_path(src_p, sid), mmap=False)
        out = {}
        for k in ARRAY_KEYS:
            arr = np.ascontiguousarray(shard[k])
            if arr.dtype not in (np.float32, np.float16):
                raise SystemExit(
                    f"shard {sid}: array '{k}' has dtype "
                    f"{'bfloat16' if arr.dtype == np.uint16 else arr.dtype}; the "
                    "reference loader only reads float32/float16 stores")
            out[k] = torch.from_numpy(arr)
        out["meta"] = shard["meta"]
        out["n_vars"] = int(shard["n_vars"])
        # the reference writer's legacy (non-zipfile) serialization; loads
        # under weights_only=True
        torch.save(out, dst_p / f"shard_{sid:05d}.pt",
                   _use_new_zipfile_serialization=False)
        print(f"shard {sid + 1}/{n_shards} exported", flush=True)
    torch.save({
        "clips": index["clips"],
        "n_shards": n_shards,
        "n_clips": index.get("n_clips") or len(index["clips"]),
        "n_variants": index["n_variants"],
        "aug_names": index.get("aug_names", ["orig"]),
        "seq_len": index.get("seq_len"),
        "frame_skip": index.get("frame_skip"),
        "feat_dtype": index.get("feat_dtype", "float32"),
        "variants_grouped": True,
        "shuffle_seed": index.get("shuffle_seed"),
        "shuffle_pool": index.get("shuffle_pool"),
    }, dst_p / "index.pt")
    return n_shards


def export_checkpoint(h36x_ckpt: str, out_pt: str) -> Path:
    """An h36x checkpoint -> the reference's state_dict (best.pt): a
    msgpack blob, an orbax directory, or an `outdir/best`-style reference
    to a slotted orbax save."""
    import torch

    from h36x_torch.models.torch_import import export_phd_to_torch
    from h36x_torch.train.checkpoint import load_params_raw

    params = load_params_raw(h36x_ckpt)
    if not isinstance(params, dict) or "input_proj" not in params:
        raise SystemExit(
            f"{h36x_ckpt} does not hold PHD model params (top-level keys: "
            f"{sorted(params) if isinstance(params, dict) else type(params)})")
    sd = export_phd_to_torch(params)
    out = Path(out_pt)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, out)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--torch-shards", default="", help="reference shard dir (index.pt)")
    p.add_argument("--torch-ckpt", default="", help="reference last.pt/best.pt")
    p.add_argument("--to-torch-shards", default="",
                   help="h36x feature store to export as a reference torch "
                        "store (--out = destination dir)")
    p.add_argument("--to-torch-ckpt", default="",
                   help="h36x .msgpack checkpoint to export as a reference "
                        "state_dict (--out = best.pt path)")
    p.add_argument("--out", required=True)
    p.add_argument("--name", default="best")
    p.add_argument("--groups", type=int, default=32,
                   help="GroupNorm groups the torch checkpoint was trained "
                        "with (shape-invisible; recorded in the manifest)")
    p.add_argument("--regressor-iters", type=int, default=3,
                   help="refinement rounds the torch checkpoint was trained "
                        "with (shape-invisible; recorded in the manifest)")
    args = p.parse_args(argv)

    if args.torch_shards:
        n = convert_shard_store(args.torch_shards, args.out)
        print(f"converted {n} shards -> {args.out}")
    if args.torch_ckpt:
        path = convert_checkpoint(args.torch_ckpt, args.out, args.name,
                                  groups=args.groups,
                                  regressor_iters=args.regressor_iters)
        print(f"converted checkpoint -> {path}")
    if args.to_torch_shards:
        n = export_shard_store(args.to_torch_shards, args.out)
        print(f"exported {n} shards -> {args.out} (reference torch format)")
    if args.to_torch_ckpt:
        path = export_checkpoint(args.to_torch_ckpt, args.out)
        print(f"exported checkpoint -> {path} (reference state_dict)")
    if not (args.torch_shards or args.torch_ckpt
            or args.to_torch_shards or args.to_torch_ckpt):
        raise SystemExit("provide --torch-shards, --torch-ckpt, "
                         "--to-torch-shards, and/or --to-torch-ckpt")


if __name__ == "__main__":
    main()
