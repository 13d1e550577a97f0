"""CLI: online serving — streaming per-frame 3D pose and AR future rollout
(counterpart of h36x/cli/predict.py).

Exposes the port's serving engines (h36x_torch/serve.py) over a feature
shard store:

  batch mode (default)  one AR rollout per clip: context joints for the
                        whole window + `--forecast` future frames, saved
                        as an NPZ.
  --streaming           replay each clip frame-by-frame through the
                        StreamingPredictor (optionally --freeze after the
                        window fills: O(1) incremental pushes) and save the
                        per-frame online predictions. The streamed result
                        at frame t uses only features <= t — what a live
                        deployment would have seen.
  --forecast 0          plain context forward, no rollout.

Runs on the GPU, the engines through the hand-written kernels; `--device
cpu` runs the plain PyTorch path on the CPU.

Output NPZ fields: predicted3djoints (B, T, J, 3), future3djoints
(B, steps, J, 3) [with --forecast > 0], joints3d (GT), meta.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None, *, use_kernels=None, precise: bool = False):
    """Returns the saved payload. `use_kernels` (callers in code only):
    None runs the kernels exactly when the device is a GPU; False runs the
    plain engines there too, the reference a kernel run is held against.
    `precise` (callers in code only; h36x's CLI has no flag for it): False,
    the serving default, bfloat16 weights and bfloat16-pair activations
    with float32 sums (:mod:`h36x_torch.infer`); True, float32."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--features-root", required=True)
    p.add_argument("--model-path", required=True, help="checkpoint .msgpack")
    p.add_argument("--out", default="outputs/predictions.npz")
    p.add_argument("--subjects", type=int, nargs="+", default=[9])
    p.add_argument("--clips", type=int, default=8, help="clips to serve")
    p.add_argument("--forecast", type=int, default=25,
                   help="AR future frames past each window (0 disables)")
    p.add_argument("--window", type=int, default=0,
                   help="streaming window (0: seq-len; with --freeze it "
                        "defaults to seq-len//2 so the frozen O(1) path "
                        "actually serves the second half of each clip)")
    p.add_argument("--streaming", action="store_true",
                   help="per-frame online replay instead of batch rollout")
    p.add_argument("--freeze", action="store_true",
                   help="with --streaming: pin GN statistics once the "
                        "window is full and push in O(1) per frame")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: cuda; 'cpu' runs "
                        "the plain PyTorch path)")
    from h36x_torch.cli.common import (
        add_model_config_flags,
        build_model_from_arch,
        resolve_model_config,
    )

    add_model_config_flags(p)
    args = p.parse_args(argv)

    from h36x_torch.data.features import FeatureClipDataset
    from h36x_torch.data.shards import as_tensor
    from h36x_torch.models.phd import param_tree
    from h36x_torch.serve import StreamingPredictor, make_rollout_fn
    from h36x_torch.train.checkpoint import checkpoint_ref_exists, load_params_only
    from h36x_torch.utils.runtime import resolve_device

    device = resolve_device(args.device)
    if use_kernels is None:
        use_kernels = device.type == "cuda"
    if not checkpoint_ref_exists(args.model_path):
        # fail before the store is opened and the model built
        raise FileNotFoundError(f"checkpoint not found: {args.model_path}")

    ds = FeatureClipDataset(args.features_root, subjects=args.subjects,
                            test_set=True)  # raises on an empty clip list
    n = min(args.clips, len(ds))
    feats, joints3d, _, _, meta = ds.get_batch(list(range(n)))
    feats = as_tensor(feats).float().numpy()  # bfloat16 stores: their bits
    feature_dim = feats.shape[-1]
    seq_len = feats.shape[1]

    mc = resolve_model_config(
        args.model_path,
        {"latent_dim": args.latent_dim, "num_blocks": args.num_blocks,
         "groups": args.groups, "regressor_iters": args.regressor_iters},
        ignore_recorded=args.ignore_model_config)
    mc["feature_dim"] = feature_dim  # the store is authoritative
    model = build_model_from_arch(mc, device="cpu")
    model.load_state_dict(load_params_only(args.model_path, model.state_dict()))
    params = param_tree(model.to(device))  # one upload, not one per push

    out: dict = {"joints3d": np.asarray(joints3d, np.float32),
                 "meta": np.asarray(meta, dtype=object)}

    if args.streaming:
        # window == seq_len would only become warm after a clip's LAST push
        # (freeze would never engage during replay), so --freeze defaults
        # to a half-clip window: warm+freeze on the first half, frozen O(1)
        # pushes on the second.
        window = args.window or (seq_len // 2 if args.freeze else seq_len)
        window = max(1, min(window, seq_len))
        preds = np.zeros((n, seq_len, mc["joints_num"], 3), np.float32)
        # --forecast applies in streaming mode too: roll each clip's AR
        # predictor past its last pushed frame
        futures = np.zeros((n, max(args.forecast, 0), mc["joints_num"], 3),
                           np.float32)
        for b in range(n):
            sp = StreamingPredictor(params, window=window,
                                    feature_dim=feature_dim,
                                    joints_num=mc["joints_num"],
                                    groups=mc["groups"],
                                    use_kernels=use_kernels,
                                    regressor_iters=mc["regressor_iters"],
                                    device=device, precise=precise)
            for t in range(seq_len):
                preds[b, t] = sp.push(feats[b, t])
                if args.freeze and sp.warm and not sp.frozen:
                    sp.freeze()
            if args.forecast > 0:
                futures[b] = sp.forecast(args.forecast)
        out["predicted3djoints"] = preds
        if args.forecast > 0:
            out["future3djoints"] = futures
        mode = ("streaming" + (" (frozen-stats O(1) push)" if args.freeze
                               else "")
                + (f" +{args.forecast} forecast frames" if args.forecast > 0
                   else ""))
    elif args.forecast > 0:
        rollout = make_rollout_fn(params, args.forecast, mc["joints_num"],
                                  mc["groups"], use_kernels=use_kernels,
                                  regressor_iters=mc["regressor_iters"],
                                  device=device, precise=precise)
        ctx, fut = rollout(feats)
        out["predicted3djoints"] = ctx.cpu().numpy().astype(np.float32)
        out["future3djoints"] = fut.cpu().numpy().astype(np.float32)
        mode = f"batch rollout (+{args.forecast} future frames)"
    else:
        # --forecast 0: plain context forward — no point paying the AR
        # rollout for a future output we would discard
        from h36x_torch.infer import make_fused_forward

        forward = make_fused_forward(params, mc["joints_num"], mc["groups"],
                                     use_kernels=use_kernels,
                                     regressor_iters=mc["regressor_iters"],
                                     precise=precise)
        out["predicted3djoints"] = forward(
            torch.from_numpy(feats).to(device)).cpu().numpy()
        mode = "batch forward"

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, **out)
    err = np.linalg.norm(
        out["predicted3djoints"] - out["joints3d"], axis=-1
    ).mean()
    print(f"Served {n} clips ({mode}); context MPJPE {err*1000:.2f} mm")
    print(f"[OK] Saved predictions to: {args.out}")
    return out


if __name__ == "__main__":
    main()
