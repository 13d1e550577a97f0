"""CLI: training on one GPU, or data-parallel on several processes
(counterpart of h36x/cli/train.py).

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
`--resume OUTDIR` continues from OUTDIR's `last` (last.msgpack, or the
orbax directory last.json names), written by this package or by h36x;
`--ckpt-backend orbax` saves orbax directories. `--optim.steps-per-dispatch K` makes K updates per
stacked group of batches, on the card one replay of a CUDA graph of the K
steps; `--optim.grad-accum K` one update over the mean gradient of K
microbatches. `--profile-dir` writes a torch.profiler trace of the first
(resumed) epoch. `--device cpu` runs the plain PyTorch path on the CPU.

Data-parallel: every process runs this CLI with the same flags plus

    --dist.num-processes N --dist.process-id I --dist.coordinator HOST:PORT

(one card per process: card I % the card count; NCCL on CUDA, gloo on
the CPU or with `--dist.collectives gloo`); each process takes its 1/N of
every batch, and rank 0 alone logs and writes. `--resume` works the same.

One process drives every visible card (h36x's mesh over `jax.devices()`),
and on the CPU `--dist.platform cpu --dist.local-devices N` makes N
virtual devices (h36x's `jax_num_cpu_devices`, CPU only): the batch splits
over them too (`--mesh.data`, `--mesh.slices`; the automatic data axis
shrinks to a divisor of the batch). `--mesh.model M` splits the wide
layers over M devices (tensor parallelism, the plain step; over
processes of one device each with `--ckpt-backend orbax`).
"""

import argparse

from h36x_torch.config import TrainConfig, add_fields, apply_namespace
from h36x_torch.data.features import FeatureClipDataset
from h36x_torch.data.sampler import MixedShardBatchSampler, SequentialBatchSampler
from h36x_torch.parallel.distributed import is_main_process, setup_from_config, shutdown
from h36x_torch.train.loop import check_supported, fit


def main(argv=None):
    """Returns fit's (model, best_val). Leaves the process group, if it
    joined one, whatever happens."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_fields(p, TrainConfig())
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: cuda; 'cpu' runs "
                        "the plain PyTorch path)")
    ns = p.parse_args(argv)
    cfg = apply_namespace(TrainConfig(), ns, skip=("device",))
    try:
        devices = setup_from_config(cfg.dist, ns.device)
        check_supported(cfg, devices)  # the mesh over the cards setup found
        return _train(cfg, devices)
    finally:
        shutdown()


def datasets(cfg):
    """(train set, val set, train sampler, val sampler) of a config, as
    h36x's CLI makes them (what :func:`h36x_torch.train.loop.fit` takes
    after the config)."""
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
    return train_set, val_set, train_sampler, val_sampler


def _train(cfg, devices):
    if not cfg.train_root:
        raise SystemExit("--train-root is required")
    train_set, val_set, train_sampler, val_sampler = datasets(cfg)

    o = cfg.optim
    log = print if is_main_process() else (lambda *a, **k: None)
    log(f"===== Phase-{o.phase} training =====")
    log(f"Device: {devices[0]} | fused kernels: {o.fused}"
        + (f" | processes: {cfg.dist.num_processes}" if cfg.dist.num_processes > 1 else "")
        + (f" | local devices: {len(devices)}" if len(devices) > 1 else ""))
    if cfg.dist.num_processes > 1:
        log(f"Processes: {cfg.dist.num_processes} | global devices: "
            f"{cfg.dist.num_processes * len(devices)}")
    if o.steps_per_dispatch > 1:
        graphed = (devices[0].type == "cuda" and cfg.dist.num_processes <= 1
                   and len(devices) == 1)
        log(f"Grouped: {o.steps_per_dispatch} steps per dispatch"
            + (" (one CUDA graph replay per group)" if graphed else ""))
    if o.grad_accum > 1:
        log(f"Grouped: gradient accumulation over {o.grad_accum} microbatches")
    if o.phase == 2:
        log(f"AR window: input {o.input_len} | horizon 1 -> {o.pred_len} over "
            f"{o.curriculum_steps} epochs | lambda_future {o.lambda_future}")
    if cfg.resume:
        log(f"Resuming from {cfg.resume}/last")
    log(f"Train clips: {len(train_set)} | Val clips: {len(val_set)}")
    log(f"Batch size: {cfg.optim.batch_size} | LR: {cfg.optim.lr} | "
        f"Epochs: {cfg.optim.epochs}")
    log("============================")
    return fit(cfg, train_set, val_set, train_sampler, val_sampler)


if __name__ == "__main__":
    main()
