"""CLI: numerical parity check against the reference's artifacts
(counterpart of h36x/cli/parity.py).

Two modes:

**Batch mode** (default): given a reference debug/results NPZ (feats + GT
joints, from the reference's teste.py or `h36x_torch.cli.debug_batch`) and
a reference torch checkpoint (last.pt / best.pt, `--torch-ckpt`) or an
h36x / port msgpack checkpoint (`--ckpt`), it runs the PHD model on the
same features and reports:

  - loss / MPJPE (m and mm) on the batch,
  - when the NPZ carries the reference's predictions
    ('predicted3djoints'), the max |delta| between the port's and the
    reference's predictions in mm: BASELINE.json's parity criterion
    (<= 0.1 mm). FAIL exits 1.

**Full-chain mode** (--full): given a torchvision ResNet-50 state_dict
(`--resnet-state-dict`), an ingested clip tree (`--clips-root`), the
reference's trained checkpoint (`--torch-ckpt`) and a reference NPZ with
meta + joints3d (+ predicted3djoints), it extracts features from the clips
(`run_extract`, the `opt` engine: on the card every stride-1 block of
ResNet-50 is one launch of the fused bottleneck kernel), looks the NPZ's
clips up in the store by (subject, action, start, cam), converts the PHD
checkpoint, predicts, and reports the MPJPE and the per-stage deltas (GT
joints against the store's rows, predictions against the reference's).
:func:`run_full` takes a clip source in memory (`dataset=`) in place of
decoding the tree's mp4s.

The forward is the engine `cli.results` uses:
`infer.make_fused_forward(..., precise=True)`, on the card the fused
GN -> ReLU -> causal-conv kernel (4 launches) and the joint-regressor
kernel (1 launch) in float32. The 0.1 mm verdict is a float32 claim: the
fast serving mode (bf16 weights) is not what it holds.

    python -m h36x_torch.cli.parity --npz debug_batch.npz --torch-ckpt best.pt

Runs on cuda unless `--device cpu` (the plain PyTorch path) is given.
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from h36x_torch.extract.pipeline import run_extract


def _report_prediction_delta(pred, data, tol_mm: float,
                             indent: str = "") -> None:
    """BASELINE.json's parity criterion, shared by both modes so the
    tolerance, verdict and exit code exist once. SystemExit(1) on FAIL."""
    if "predicted3djoints" not in data:
        print(f"{indent}npz carries no reference predictions; "
              "prediction-delta check skipped")
        return
    ref_pred = np.asarray(data["predicted3djoints"], dtype=np.float32)
    delta_mm = float(np.abs(pred - ref_pred).max()) * 1000.0
    verdict = "PASS" if delta_mm <= tol_mm else "FAIL"
    print(f"{indent}max |h36x_torch - reference| prediction delta: "
          f"{delta_mm:.4f} mm (tolerance {tol_mm} mm) -> {verdict}")
    if verdict == "FAIL":
        raise SystemExit(1)


def _model(mc: dict, state_dict: dict, device: torch.device):
    """The PHD model of `mc` holding `state_dict` (every key and shape
    checked), on `device`."""
    from h36x_torch.cli.common import build_model_from_arch

    model = build_model_from_arch(mc, device="cpu")
    model.load_state_dict(state_dict)
    return model.to(device)


def _predict(model, feats: np.ndarray) -> np.ndarray:
    """joints (B, T, J, 3) of `feats` through make_fused_forward at
    precise=True on the model's device."""
    from h36x_torch.infer import make_fused_forward
    from h36x_torch.models.phd import param_tree

    forward = make_fused_forward(param_tree(model), joints_num=model.joints_num,
                                 groups=model.groups,
                                 regressor_iters=model.regressor_iters, precise=True)
    device = next(model.parameters()).device
    return forward(torch.from_numpy(np.ascontiguousarray(feats)).to(device)).cpu().numpy()


def run_full(args, dataset=None) -> None:
    """state_dict -> extract -> lookup -> convert -> predict -> deltas.
    `dataset`: a clip source for run_extract in place of the tree's mp4s
    (the interface of :class:`h36x_torch.data.clips.ClipDataset`)."""
    from h36x_torch.cli.common import resolve_model_config
    from h36x_torch.config import ExtractConfig
    from h36x_torch.data.features import FeatureClipDataset
    from h36x_torch.models.phd import params_from_flax
    from h36x_torch.models.torch_import import load_torch_phd
    from h36x_torch.train.losses import mpjpe
    from h36x_torch.utils.runtime import resolve_device

    if not (args.resnet_state_dict and args.clips_root and args.torch_ckpt):
        raise SystemExit(
            "--full needs --resnet-state-dict, --clips-root and --torch-ckpt")
    device = resolve_device(args.device)
    workdir = Path(args.workdir or "parity_work")
    features = workdir / "features"

    data = np.load(args.npz, allow_pickle=True)
    if "meta" not in data:
        raise SystemExit(
            f"{args.npz} carries no 'meta' — --full locates the reference "
            "batch's clips by meta (subject, action, start); regenerate the "
            "NPZ with teste.py / h36x_torch.cli.results --save-n")
    meta = list(data["meta"])
    subjects = sorted({int(m["subject"]) for m in meta})
    t_len = int(np.asarray(data["joints3d"]).shape[1])

    if not (features / "index.json").exists():
        cfg = ExtractConfig(
            root=args.clips_root, out=str(features),
            weights=args.resnet_state_dict, subjects=subjects,
            seq_len=t_len, stride=args.stride, frame_skip=args.frame_skip,
            resize=args.resize, augment=False, batch_size=args.batch_size,
            num_workers=args.num_workers, engine="opt",
            # parity is defined on the reference's per-clip crop boxes
            crop_scope="clip", jitter_key="clip",
        )
        print(f"[1/3] extracting features for subjects {subjects} "
              f"-> {features}")
        run_extract(cfg, dataset=dataset, device=device)
    else:
        # a store extracted for another npz or other flags would still
        # answer the (subject, action, start) lookups, on the wrong frames
        from h36x_torch.data.shards import load_index

        idx = load_index(features)
        stale = {
            k: (idx.get(k), v)
            for k, v in (("seq_len", t_len), ("frame_skip", args.frame_skip))
            if idx.get(k) is not None and idx.get(k) != v
        }
        if stale:
            raise SystemExit(
                f"existing feature store {features} was extracted with "
                f"different parameters {stale} (store value, current) — "
                "delete it or pass a fresh --workdir")
        print(f"[1/3] reusing existing feature store {features}")

    print("[2/3] locating the reference batch's clips in the store")
    store = FeatureClipDataset(features, test_set=True)
    # H36M has 4 cameras per action with identical (subject, action, start)
    # triples: the camera disambiguates; the lookup reads the index only
    use_cam = all("cam" in m for m in meta)
    if not use_cam:
        print("    NPZ meta carries no 'cam' — lookups use (subject, "
              "action, start); ambiguous on multi-camera stores")

    def key_of(m):
        base = (int(m["subject"]), str(m["action"]), int(m["start"]))
        return base + (str(m["cam"]),) if use_cam else base

    by_key = {}
    for i, (clip, _var) in enumerate(store.items):
        k = key_of(clip)
        if not use_cam and k in by_key:
            raise SystemExit(
                f"clip key {k} is ambiguous in the store (multiple cameras) "
                "but the NPZ meta has no 'cam' field — regenerate the NPZ "
                "with camera info")
        by_key[k] = i
    rows = []
    for m in meta:
        key = key_of(m)
        if key not in by_key:
            raise SystemExit(
                f"clip {key} from the NPZ is not in the extracted store — "
                "check --clips-root/--stride/--frame-skip match the "
                "reference extraction flags")
        rows.append(by_key[key])
    feats, j3d_store, *_ = store.get_batch(rows)

    gt = np.asarray(data["joints3d"], dtype=np.float32)
    gt_delta_mm = float(np.abs(j3d_store - gt).max()) * 1000.0
    print(f"    GT-joints delta store-vs-npz: {gt_delta_mm:.4f} mm "
          "(validates ingestion + windowing + geometry)")

    print("[3/3] converting the PHD checkpoint and predicting")
    mc = resolve_model_config(
        "", {"latent_dim": args.latent_dim, "num_blocks": args.num_blocks})
    mc["feature_dim"] = int(feats.shape[-1])
    model = _model(mc, params_from_flax(load_torch_phd(args.torch_ckpt)), device)
    pred = _predict(model, feats)
    mp = float(mpjpe(torch.from_numpy(pred), torch.from_numpy(gt)))
    print(f"    mpjpe vs NPZ GT: {mp:.6f} m = {mp*1000:.3f} mm")

    _report_prediction_delta(pred, data, args.tol_mm, indent="    ")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--npz", required=True,
                   help="debug_batch.npz / batch_result npz with features+GT")
    p.add_argument("--torch-ckpt", default="",
                   help="reference last.pt/best.pt (torch) to convert")
    p.add_argument("--ckpt", default="", help="h36x .msgpack checkpoint")
    p.add_argument("--latent-dim", type=int, default=None,
                   help="default: recorded in the --ckpt manifest when "
                        "present, else 1024")
    p.add_argument("--num-blocks", type=int, default=None,
                   help="default: recorded in the --ckpt manifest when "
                        "present, else 2")
    p.add_argument("--ignore-model-config", action="store_true",
                   help="ignore the architecture recorded in the --ckpt "
                        "manifest and use flags/defaults")
    p.add_argument("--tol-mm", type=float, default=0.1)
    p.add_argument("--full", action="store_true",
                   help="full-chain runbook: backbone state_dict -> "
                        "extraction -> PHD checkpoint -> MPJPE delta")
    p.add_argument("--resnet-state-dict", default="",
                   help="[--full] torchvision ResNet-50 state_dict .pt file")
    p.add_argument("--clips-root", default="",
                   help="[--full] ingested clip tree to extract from")
    p.add_argument("--workdir", default="",
                   help="[--full] where the feature store goes "
                        "(reused if already extracted)")
    p.add_argument("--stride", type=int, default=5)
    p.add_argument("--frame-skip", type=int, default=2)
    p.add_argument("--resize", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    if args.full:
        run_full(args)
        return

    from h36x_torch.cli.common import resolve_model_config
    from h36x_torch.models.phd import params_from_flax
    from h36x_torch.train.losses import mpjpe, mse3d
    from h36x_torch.utils.runtime import resolve_device

    device = resolve_device(args.device)
    data = np.load(args.npz, allow_pickle=True)
    feats = np.asarray(data["video"], dtype=np.float32)
    if feats.ndim != 3:
        raise SystemExit(
            f"'video' in {args.npz} has shape {feats.shape}; parity needs a "
            "feature batch (B,T,2048) — regenerate with teste.py / "
            "h36x_torch.cli.debug_batch on the feature store."
        )
    joints3d = np.asarray(data["joints3d"], dtype=np.float32)

    # every architecture field, groups and regressor_iters included: they
    # are in no shape, and a mismatch would score the verdict on garbage
    mc = resolve_model_config(
        args.ckpt or "",
        {"latent_dim": args.latent_dim, "num_blocks": args.num_blocks},
        ignore_recorded=args.ignore_model_config)
    mc["feature_dim"] = int(feats.shape[-1])
    if args.torch_ckpt:
        from h36x_torch.models.torch_import import load_torch_phd

        state = params_from_flax(load_torch_phd(args.torch_ckpt))
        print(f"Converted torch checkpoint {args.torch_ckpt}")
    elif args.ckpt:
        from h36x_torch.cli.common import build_model_from_arch
        from h36x_torch.train.checkpoint import load_params_only

        template = build_model_from_arch(mc, device="cpu").state_dict()
        state = load_params_only(args.ckpt, template)
        print(f"Loaded h36x checkpoint {args.ckpt}")
    else:
        raise SystemExit("provide --torch-ckpt or --ckpt")

    pred = _predict(_model(mc, state, device), feats)
    loss = float(mse3d(torch.from_numpy(pred), torch.from_numpy(joints3d)))
    mp = float(mpjpe(torch.from_numpy(pred), torch.from_numpy(joints3d)))
    print(f"batch loss: {loss:.6f} | mpjpe: {mp:.6f} m = {mp*1000:.3f} mm")

    _report_prediction_delta(pred, data, args.tol_mm)


if __name__ == "__main__":
    main()
