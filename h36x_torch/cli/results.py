"""CLI: test-subject evaluation + one-batch NPZ dump on the GPU
(counterpart of h36x/cli/results.py); the evaluation runs data-parallel
over every visible card when there is more than one.

    python -m h36x_torch.cli.results --features-root STORE \\
        --preprocessed-root INGESTED --model-path runs/best.msgpack \\
        [--fused] [--device cpu]

The evaluation runs on the GPU through the hand-written kernels; `--fused`
routes the one-batch prediction dump through them too (make_fused_forward).
`--device cpu` runs the plain PyTorch path on the CPU. The dump re-decodes
each saved row's mp4 clip, which needs OpenCV.
"""

import argparse

from h36x_torch.config import SEQ_LEN, TEST_SUBJECTS


def main(argv=None):
    """Returns the saved payload."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--features-root", required=True)
    p.add_argument("--preprocessed-root", required=True)
    p.add_argument("--model-path", required=True, help="checkpoint .msgpack")
    p.add_argument("--out", default="outputs/batch_result_S9.npz")
    p.add_argument("--seq-len", type=int, default=None,
                   help="clip window length; default: the evaluated store's "
                        f"own seq_len (falls back to {SEQ_LEN})")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--save-n", type=int, default=16)
    p.add_argument("--video-size", type=int, default=224, help="0 disables resize")
    p.add_argument("--subjects", type=int, nargs="+", default=list(TEST_SUBJECTS))
    p.add_argument("--device", default=None,
                   help="torch device to evaluate on (default: cuda; 'cpu' "
                        "runs the plain PyTorch path)")
    from h36x_torch.cli.common import (
        add_model_config_flags,
        build_model_from_arch,
        resolve_model_config,
    )

    add_model_config_flags(p)
    p.add_argument("--fused", action="store_true",
                   help="use the fused serving path (h36x_torch.infer, the "
                        "hand-written kernels on the GPU) for the one-batch "
                        "prediction dump")
    args = p.parse_args(argv)

    from h36x_torch.data.features import FeatureClipDataset
    from h36x_torch.train.checkpoint import checkpoint_ref_exists, load_params_only
    from h36x_torch.train.results import dump_result_batch, evaluate_test
    from h36x_torch.utils.runtime import local_devices, resolve_device

    device = resolve_device(args.device)
    if not checkpoint_ref_exists(args.model_path):
        # fail before the store is opened and the model built
        raise FileNotFoundError(f"checkpoint not found: {args.model_path}")

    test_set = FeatureClipDataset(args.features_root, subjects=args.subjects,
                                  test_set=True)
    feats0 = test_set.get_batch([0])[0]
    # the feature width comes from the store, not a hardcoded 2048
    feature_dim = int(feats0.shape[-1])
    # the store being evaluated is authoritative for T (a mismatched flag
    # would mis-window the NPZ video dump)
    seq_len = args.seq_len if args.seq_len is not None else int(feats0.shape[1])
    mc = resolve_model_config(
        args.model_path,
        {"latent_dim": args.latent_dim, "num_blocks": args.num_blocks,
         "groups": args.groups, "regressor_iters": args.regressor_iters},
        ignore_recorded=args.ignore_model_config)
    mc["feature_dim"] = feature_dim
    model = build_model_from_arch(mc, device="cpu")
    model.load_state_dict(load_params_only(args.model_path, model.state_dict()))
    model.to(device)  # one upload, not one per eval batch

    mesh = None
    devices = local_devices(device)
    if len(devices) > 1:
        from h36x_torch.parallel.mesh import make_mesh

        mesh = make_mesh(data=-1, model=1, devices=devices)
        print(f"Test eval over {mesh.shape['data']} devices (data-parallel)")
    loss, mp, l3d, l2d = evaluate_test(model, test_set, args.batch_size, mesh=mesh)
    print(
        f"Test metrics | loss: {loss:.6f} | mpjpe (m): {mp:.6f} "
        f"| mpjpe (mm): {mp*1000.0:.2f} | l3d: {l3d:.6f} "
        "| l2d: n/a (not computed; NPZ stores 0.0 for field parity)"
    )

    out_hw = None if args.video_size == 0 else args.video_size
    forward_fn = None
    if args.fused:
        from h36x_torch.infer import make_fused_forward
        from h36x_torch.models.phd import param_tree

        # the results stage keeps float32 (precise), as evaluate_test does
        forward_fn = make_fused_forward(param_tree(model),
                                        joints_num=model.joints_num,
                                        groups=model.groups,
                                        regressor_iters=model.regressor_iters,
                                        precise=True)
    payload = dump_result_batch(
        model, test_set, args.preprocessed_root, args.out,
        seq_len=seq_len, batch_size=args.batch_size, save_n=args.save_n,
        video_size=out_hw, test_metrics=(loss, mp, l3d, l2d),
        forward_fn=forward_fn,
    )
    print(f"[OK] Saved batch to: {args.out}")
    return payload


if __name__ == "__main__":
    main()
