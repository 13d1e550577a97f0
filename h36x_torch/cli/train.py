"""CLI: training on one GPU (counterpart of h36x/cli/train.py).

    python -m h36x_torch.cli.train --train-root STORE [--optim.fused true] \\
        [--optim.phase 1|2|0] [--init-from CKPT] [--resume OUTDIR] \\
        [--optim.steps-per-dispatch K | --optim.grad-accum K] \\
        [--profile-dir DIR] [--device cpu] [the --data.* / --model.* /
        --optim.* flags of h36x]

trains on the GPU. Phase 1 (the default) freezes f_AR and trains f_movie +
f_3D; `--optim.fused true` runs every residual block forward and backward
through the hand-written kernels (and the regressor too at
`--model.dropout 0`). Phase 2 trains f_AR alone on the curriculum
(`--optim.input-len`, `--optim.pred-len`, `--optim.curriculum-steps`,
`--optim.lambda-future`), usually `--init-from` a phase-1 checkpoint, on
the plain path (it refuses `--optim.fused`); phase 0 trains everything.
`--resume OUTDIR` continues from OUTDIR/last.msgpack, written by this
package or by h36x. `--optim.steps-per-dispatch K` makes K updates per
stacked group of batches, on the card one replay of a CUDA graph of the K
steps; `--optim.grad-accum K` one update over the mean gradient of K
microbatches. `--profile-dir` writes a torch.profiler trace of the first
(resumed) epoch. `--device cpu` runs the plain PyTorch path on the CPU.
Orbax checkpoints, bfloat16 compute and multi-device runs come with later
slices and raise.
"""

import argparse

from h36x_torch.config import TrainConfig, add_fields, apply_namespace
from h36x_torch.data.features import FeatureClipDataset
from h36x_torch.data.sampler import MixedShardBatchSampler, SequentialBatchSampler
from h36x_torch.train.loop import check_supported, fit
from h36x_torch.utils.runtime import resolve_device


def main(argv=None):
    """Returns fit's (model, best_val)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_fields(p, TrainConfig())
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: cuda; 'cpu' runs "
                        "the plain PyTorch path)")
    ns = p.parse_args(argv)
    cfg = apply_namespace(TrainConfig(), ns, skip=("device",))
    device = resolve_device(ns.device)
    check_supported(cfg)

    if not cfg.train_root:
        raise SystemExit("--train-root is required")
    val_root = cfg.val_root or cfg.train_root
    train_set = FeatureClipDataset(
        cfg.train_root,
        subjects=cfg.train_subjects,
        augment=cfg.data.augment,
        max_clips=cfg.data.max_clips,
        # -1 is the auto sentinel; 0 is a valid value (no caching)
        shard_cache_size=(64 if cfg.data.shard_cache_size < 0
                          else cfg.data.shard_cache_size),
        log_loads_every=cfg.data.log_shard_loads,
    )
    val_set = FeatureClipDataset(val_root, subjects=cfg.val_subjects)
    train_sampler = MixedShardBatchSampler(
        train_set, batch_size=cfg.optim.batch_size, shuffle=True, drop_last=True,
        seed=cfg.optim.seed,
    )
    val_sampler = SequentialBatchSampler(val_set, batch_size=cfg.optim.batch_size)

    o = cfg.optim
    print(f"===== Phase-{o.phase} training =====")
    print(f"Device: {device} | fused kernels: {o.fused}")
    if o.steps_per_dispatch > 1:
        print(f"Grouped: {o.steps_per_dispatch} steps per dispatch"
              + (" (one CUDA graph replay per group)" if device.type == "cuda" else ""))
    if o.grad_accum > 1:
        print(f"Grouped: gradient accumulation over {o.grad_accum} microbatches")
    if o.phase == 2:
        print(f"AR window: input {o.input_len} | horizon 1 -> {o.pred_len} over "
              f"{o.curriculum_steps} epochs | lambda_future {o.lambda_future}")
    if cfg.resume:
        print(f"Resuming from {cfg.resume}/last.msgpack")
    print(f"Train clips: {len(train_set)} | Val clips: {len(val_set)}")
    print(f"Batch size: {cfg.optim.batch_size} | LR: {cfg.optim.lr} | "
          f"Epochs: {cfg.optim.epochs}")
    print("============================")
    return fit(cfg, train_set, val_set, train_sampler, val_sampler, device=device)


if __name__ == "__main__":
    main()
