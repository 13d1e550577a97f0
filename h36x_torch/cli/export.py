"""CLI: compile a trained checkpoint into a self-contained serving artifact
(counterpart of h36x/cli/export.py).

Writes one `.pt2` file (torch.export) holding the PHD forward, or the AR
future rollout, with the trained weights baked in. A serving host needs
only PyTorch (no h36x_torch, no model code, no checkpoint) to run

    import torch
    ep = torch.export.load("phd.pt2")
    ep = torch.export.passes.move_to_device_pass(ep, "cuda")
    with torch.inference_mode():
        joints = ep.module()(feats)   # feats (B, seq_len, feature_dim) f32

or serves it with `python -m h36x_torch.cli.serve --artifact phd.pt2`.
The batch dimension is symbolic unless --batch is given. A `.json`
sidecar records shapes, platforms, kind, dtype and the file's sha256. The
artifact runs the plain PyTorch ops (h36x_torch.export says why).

    python -m h36x_torch.cli.export --model-path runs/best.msgpack \\
        --out outputs/phd.pt2 [--kind rollout --forecast 25] \\
        [--dtype bfloat16] [--check --device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-path", required=True, help="checkpoint .msgpack")
    p.add_argument("--out", default="outputs/phd.pt2")
    p.add_argument("--kind", choices=["forward", "rollout"], default="forward")
    p.add_argument("--forecast", type=int, default=25,
                   help="rollout only: future frames baked into the artifact")
    p.add_argument("--seq-len", type=int, default=None,
                   help="artifact window length; default: the checkpoint "
                        "manifest's data.seq_len (falls back to 40)")
    p.add_argument("--feature-dim", type=int, default=None,
                   help="input feature width; default: the value recorded "
                        "in the checkpoint manifest (falls back to 2048)")
    p.add_argument("--batch", type=int, default=None,
                   help="fix the batch dimension (default: symbolic)")
    p.add_argument("--platforms", default="cpu,cuda",
                   help="comma-separated devices the artifact is meant for "
                        "(cpu, cuda), recorded in its metadata: a torch.export "
                        "program runs on whichever device it is moved to")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="compute/weight dtype baked into the artifact "
                        "(bfloat16: half the file; interface stays f32)")
    p.add_argument("--device", default=None,
                   help="torch device --check runs the artifact and the model "
                        "on (default: cuda; 'cpu' for a host without one)")
    from h36x_torch.cli.common import add_model_config_flags

    add_model_config_flags(p)
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and compare it against the "
                        "model's float32 forward on random features")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from h36x_torch.cli.common import build_model_from_arch, resolve_model_config
    from h36x_torch.export import (
        _platforms,
        artifact_info,
        export_forward,
        export_rollout,
        load_artifact,
        save_artifact,
    )
    from h36x_torch.infer import phd_forward_fused
    from h36x_torch.models.phd import param_tree
    from h36x_torch.train import checkpoint as ckpt

    try:
        platforms = _platforms(args.platforms.split(","))
    except ValueError as e:
        raise SystemExit(f"--platforms {args.platforms}: {e}") from None
    mc = resolve_model_config(
        args.model_path,
        {"latent_dim": args.latent_dim, "num_blocks": args.num_blocks,
         "groups": args.groups, "regressor_iters": args.regressor_iters,
         "feature_dim": args.feature_dim},
        ignore_recorded=args.ignore_model_config)
    feature_dim = mc["feature_dim"]
    seq_len = args.seq_len
    if seq_len is None and not args.ignore_model_config:
        seq_len = ((ckpt.load_recorded_config(args.model_path)
                    .get("data") or {}).get("seq_len"))
    if seq_len is None:
        seq_len = 40
    model = build_model_from_arch(mc, device="cpu")
    model.load_state_dict(ckpt.load_params_only(args.model_path, model.state_dict()))
    params = param_tree(model)

    common = dict(
        seq_len=seq_len, feature_dim=feature_dim, joints_num=mc["joints_num"],
        groups=mc["groups"], batch=args.batch,
        regressor_iters=mc["regressor_iters"],
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else None,
        platforms=platforms,
    )
    if args.kind == "rollout":
        blob = export_rollout(params, steps=args.forecast, **common)
    else:
        blob = export_forward(params, **common)

    path = save_artifact(blob, args.out)
    info = artifact_info(blob)
    info["kind"] = args.kind
    info["dtype"] = args.dtype
    # integrity record: a copy is checked against it before it is served
    info["sha256"] = hashlib.sha256(blob).hexdigest()
    if args.kind == "rollout":
        info["forecast"] = args.forecast
    with open(str(path) + ".json", "w") as f:
        json.dump(info, f, indent=2)
    print(f"[OK] {args.kind} artifact -> {path} "
          f"({info['nbytes'] / 1e6:.1f} MB, platforms {info['platforms']}, "
          f"in {info['in_avals']})")

    if args.check:
        fn = load_artifact(blob, device=args.device)
        feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (2, seq_len, feature_dim), dtype=np.float32)).to(fn.device)
        got = fn(feats)
        joints_got = got[0] if args.kind == "rollout" else got
        model.to(fn.device)
        with torch.inference_mode():
            want = phd_forward_fused(param_tree(model), feats,
                                     joints_num=mc["joints_num"],
                                     groups=mc["groups"], use_kernels=False,
                                     regressor_iters=mc["regressor_iters"],
                                     precise=True)[2]
        err = float((joints_got - want).abs().max())
        tol = 1e-4 if args.dtype == "float32" else 2e-2
        print(f"[check] max |artifact - model forward (f32)| = {err:.3e} "
              f"(tol {tol:g})")
        if not err <= tol:
            raise SystemExit(f"artifact check failed: {err:.3e} > {tol:g}")


if __name__ == "__main__":
    main()
