"""Epoch-level training loop (counterpart of h36x/train/loop.py, phases 1,
2 and 0), on one device or over h36x's (slice, data, model) mesh of this
process's local devices and the process group
(:mod:`h36x_torch.parallel.mesh`, :mod:`h36x_torch.parallel.distributed`).

Per epoch: the sampler reshuffles (`set_epoch`), the cosine learning rate
is set (and in phase 2 the curriculum horizon), the train pass runs
(batches fed by a background thread, stacked into groups for the grouped
steps), then the weighted eval pass; `best` is saved on a val-MPJPE
improvement before `last`, a record goes to <outdir>/metrics.jsonl, and
early stopping and `stop_after_epochs` end the run. `--resume` continues
from a `last` checkpoint of either package and either backend
(`--ckpt-backend msgpack | orbax`); `--profile-dir` traces the first
(resumed) epoch. What the port does not run raises (:func:`check_supported`).

Data-parallel: every batch is padded to the data axis by repeating its
last index (weight 0 in the eval); every process walks the same seeded
sampler order and gathers only its rows of each global batch, which its
local data replicas split again (:class:`h36x_torch.parallel.local.Replicas`);
the steps average gradients and metrics over the data axis, the eval's
per-batch sums are summed over the processes, and rank 0 alone prints and
writes metrics.jsonl and checkpoints.

Tensor-parallel (`--mesh.model M > 1`): over M processes of one device
each, each process keeps its slices of the split params
(:func:`h36x_torch.parallel.tensor.shard_model`); over M local devices the
model keeps its full params and runs its split products on them
(:func:`h36x_torch.parallel.tensor.shard_local`). Both run the plain step.
As in h36x, the fused step is refused with a model axis, and msgpack
checkpoints with a model axis over processes; an orbax save gathers the
full arrays to rank 0, and `--resume` and `--init-from` read full arrays
and keep each rank's slices.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from h36x_torch.config import TrainConfig
from h36x_torch.models.phd import PHDFor3DJoints
from h36x_torch.parallel.distributed import (
    check_local_devices,
    data_info,
    init_groups,
    local_batch_slice,
    process_devices,
    process_info,
    sum_across_processes,
)
from h36x_torch.parallel.feed import feed_dtype, prefetch_to_device
from h36x_torch.parallel.local import Replicas
from h36x_torch.parallel.mesh import Mesh, data_axis_size, global_devices, make_mesh
from h36x_torch.parallel.tensor import shard_local, shard_model
from h36x_torch.train import checkpoint as ckpt
from h36x_torch.train.state import cosine_lr, make_optimizer, set_learning_rate
from h36x_torch.train.step import (
    curriculum_horizon,
    make_future_train_step,
    make_train_step,
    make_weighted_eval_step,
    make_weighted_future_eval_step,
)
from h36x_torch.utils.profiling import maybe_trace, span
from h36x_torch.utils.runtime import local_devices, resolve_device
from h36x_torch.utils.timers import PhaseTimers

# --model.dtype -> the model's compute dtype (h36x's names: h36x/config.py)
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16,
                  "bf16": torch.bfloat16}


def check_supported(cfg: TrainConfig, devices=None) -> Mesh:
    """Raise for every setting the port does not run, rather than run
    something else; return the mesh, chosen by h36x's rules
    (h36x/train/loop.py::fit) over the global device list: this process's
    `devices` (default: --dist.local-devices unnamed devices, at least one)
    on each of --dist.num-processes processes. The automatic data axis
    shrinks to a divisor of the batch; an explicit --mesh.data that does not
    divide it raises; a multi-process run must use every device."""
    _check_config(cfg, devices[0] if devices else None)
    if devices is None:
        devices = [None] * max(1, cfg.dist.local_devices)
    processes = max(1, cfg.dist.num_processes)
    every = global_devices(devices, processes, process_info()[0])
    n_dev, batch = len(every), cfg.optim.batch_size
    model_ax, slices = max(1, cfg.mesh.model), max(1, cfg.mesh.slices)
    if model_ax > n_dev or n_dev % model_ax != 0:
        raise ValueError(f"--mesh.model {model_ax} must divide the device count ({n_dev})")
    if slices > 1:
        if n_dev % (slices * model_ax) != 0:
            raise ValueError(f"{n_dev} devices not divisible by slices*model="
                             f"{slices * model_ax}")
        data_ax = cfg.mesh.data if cfg.mesh.data > 0 else n_dev // (slices * model_ax)
        if batch % (slices * data_ax) != 0:
            raise ValueError(
                f"the combined slice*data axis ({slices * data_ax}) must divide the "
                f"batch size ({batch}) — pick a batch that is a multiple of slices*data")
        mesh = make_mesh(data_ax, model_ax, every, slices=slices)
    else:
        explicit = cfg.mesh.data > 0
        data_ax = cfg.mesh.data if explicit else n_dev // model_ax
        if explicit and batch % data_ax != 0:
            raise ValueError(
                f"--mesh.data {data_ax} does not divide the batch size ({batch}); "
                "adjust one of them (or drop --mesh.data to auto-fit)")
        while data_ax > 1 and batch % data_ax != 0:
            data_ax -= 1
        n_used = data_ax * model_ax
        if n_used < n_dev:
            if processes > 1:
                raise ValueError(
                    f"multi-process runs must use every device: batch {batch} / mesh "
                    f"{cfg.mesh} leaves {n_dev - n_used}/{n_dev} devices idle (the "
                    "data axis must divide the batch size)")
            _log(f"mesh: using {n_used}/{n_dev} devices (data={data_ax}, "
                 f"model={model_ax}; batch {batch} must divide the data axis)")
        mesh = make_mesh(data_ax, model_ax, every[:n_used])
    check_mesh(cfg, mesh)
    return mesh


def _check_config(cfg: TrainConfig, device=None) -> None:
    o, m = cfg.optim, cfg.model
    if o.phase not in (0, 1, 2):
        raise ValueError(f"unknown --optim.phase {o.phase} (0, 1 or 2)")
    if cfg.ckpt_backend not in ("msgpack", "orbax"):
        raise ValueError(f"unknown ckpt_backend {cfg.ckpt_backend!r}")
    if m.dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown --model.dtype {m.dtype!r} "
                         f"({', '.join(COMPUTE_DTYPES)})")
    check_local_devices(cfg.dist, device)


def check_mesh(cfg: TrainConfig, mesh: Mesh) -> None:
    """h36x's refusals that read the mesh: a batch axis that does not
    split among the processes, msgpack checkpoints with a model axis over
    processes, the fused step with a model axis."""
    processes = max(1, cfg.dist.num_processes)
    rows = data_axis_size(mesh)
    if cfg.optim.batch_size % rows != 0:
        raise ValueError(f"the batch axis splits {rows} ways and must divide the "
                         f"batch size ({cfg.optim.batch_size})")
    local = 1 if mesh.devices is None else mesh.local_count
    # the processes that read different rows (a model axis over processes
    # reads one block on each of its ranks)
    readers = processes // (mesh.model // local if mesh.model > local else 1)
    if rows % readers != 0:
        raise ValueError(f"batch-sharding axis {rows} not divisible by {readers} "
                         "processes — local_batch_slice needs equal row counts")
    if processes > 1 and cfg.ckpt_backend == "msgpack" and mesh.model > local:
        # h36x's refusal: rank 0 cannot device_get the other processes' shards
        raise ValueError(
            f"model axis {mesh.model} spans processes (local devices: {local}); use "
            "--ckpt-backend orbax, whose saves are collective")
    if mesh.model > 1 and cfg.optim.fused:
        raise ValueError(
            "--optim.fused does not support --mesh.model > 1; use the default "
            "plain step for tensor parallelism")


def build_model(cfg: TrainConfig, device=None,
                generator: Optional[torch.Generator] = None) -> PHDFor3DJoints:
    m = cfg.model
    return PHDFor3DJoints(
        latent_dim=m.latent_dim,
        feature_dim=m.feature_dim,
        joints_num=m.joints_num,
        number_blocks=m.num_blocks,
        ar_blocks=m.ar_num_blocks,
        groups=m.groups,
        kernel_size=m.kernel_size,
        regressor_iters=m.regressor_iters,
        regressor_hidden=m.regressor_hidden,
        dropout=m.dropout,
        generator=generator,
        device=device,
        dtype=COMPUTE_DTYPES[m.dtype],
    )


def _batches(dataset, sampler, device, feats_dtype, with_weights: bool = False,
             stack: int = 1, pad_to: int = 1):
    """Host batches -> device batches, prefetched by a background thread.
    A batch whose rows do not divide the data axis (`pad_to`, at least the
    processes') is padded by repeating its last index; each process of the
    process group then gathers only its `local_batch_slice` rows of every
    global batch. With with_weights every batch
    gains a float32 (B,) weight vector, 1 on real rows and 0 on padded ones
    (the weighted eval step's contract).

    stack > 1 groups that many consecutive batches into one batch with a
    leading step axis (k, B, ...) for the grouped train steps. A batch with
    another row count (a short tail with drop_last=False) flushes the group
    and rides a group of its own; the last group of an epoch may be
    shorter."""

    rank, processes = data_info()
    pad_to = max(pad_to, processes)

    def gen():
        for idx_batch in sampler:
            idx_batch = list(idx_batch)
            real = len(idx_batch)
            if real % pad_to:
                idx_batch += [idx_batch[-1]] * (pad_to - real % pad_to)
            rows = local_batch_slice(len(idx_batch), rank, processes)
            batch = dataset.get_batch(idx_batch[rows])[:4]
            if with_weights:
                w = np.zeros(len(idx_batch), dtype=np.float32)
                w[:real] = 1.0
                batch = (*batch, w[rows])
            yield batch

    def stacked():
        group = []
        for batch in gen():
            if group and batch[0].shape[0] != group[0][0].shape[0]:
                yield tuple(np.stack(xs) for xs in zip(*group))
                group = []
            group.append(batch)
            if len(group) == stack:
                yield tuple(np.stack(xs) for xs in zip(*group))
                group = []
        if group:
            yield tuple(np.stack(xs) for xs in zip(*group))

    return prefetch_to_device(stacked() if stack > 1 else gen(), device,
                              feats_dtype=feats_dtype)


def _drain(pending: list, totals: dict) -> None:
    """Add the device metric dicts of `pending` (0-d, or stacked (k,) for a
    group) into `totals` (one copy to the host), then empty `pending`. The
    steps' values are added one by one in step order, so grouping the same
    steps differently gives the same sums, bit for bit."""
    if not pending:
        return
    keys = list(totals)
    host = torch.cat([torch.stack([m[k].reshape(-1) for k in keys], dim=1)
                      for m in pending]).double().tolist()
    for row in host:
        for k, v in zip(keys, row):
            totals[k] += v
    pending.clear()


def _log(*args, **kwargs) -> None:
    """print on rank 0 only."""
    if process_info()[0] == 0:
        print(*args, **kwargs)


def train_epoch(train_step, dataset, sampler, device, feats_dtype, generator,
                log_every: int = 500, horizon: Optional[int] = None, pad_to: int = 1):
    """One epoch. Metric tensors stay on the device until a log point or
    the epoch's end, so steps are not synchronised one by one. A grouped
    step (`train_step.group` > 1) takes stacked groups of batches; `n`
    counts batches either way, so the means are per batch. `horizon`, when
    given, is passed to the (phase-2) step. Reports `l2d` and `l_ar` when
    the step does. The steps' metrics are already the global batch's
    under several processes."""
    timers = PhaseTimers()
    pending: list = []
    totals = {"loss": 0.0, "l3d": 0.0, "mpjpe": 0.0}
    n = 0
    last_log = 0
    replays0, eager0 = train_step.graph_replays, train_step.eager_steps
    epoch_start = time.perf_counter()
    extra = () if horizon is None else (horizon,)
    stack = train_step.group

    timers.start("data")
    for batch in _batches(dataset, sampler, device, feats_dtype, stack=stack,
                          pad_to=pad_to):
        timers.stop("data")
        timers.start("step")
        with span("train_step"):
            metrics = train_step(batch, generator, *extra)
        if not pending and not n:
            for k in ("l2d", "l_ar"):
                if k in metrics:
                    totals[k] = 0.0
        pending.append(metrics)
        n += int(batch[0].shape[0]) if stack > 1 else 1
        timers.stop("step")
        if log_every > 0 and n - last_log >= log_every:
            last_log = n
            _drain(pending, totals)
            _log(f"[3D]  iter {n:05d} | loss {totals['loss']/n:.6f} "
                 f"(3d {totals['l3d']/n:.6f}) | mpjpe {totals['mpjpe']/n:.3f} | "
                 f"epoch {time.perf_counter()-epoch_start:.1f}s", flush=True)
        timers.start("data")
    timers.stop("data")
    timers.start("drain")
    _drain(pending, totals)
    timers.stop("drain")
    if n == 0:
        _log("WARNING: the train sampler yielded ZERO batches this epoch — "
             "check batch_size / shards_per_batch against the store's shard "
             "count and split sizes.", flush=True)
    _log("[Train timing]\n" + timers.summary(n), flush=True)
    means = {k: v / max(n, 1) for k, v in totals.items()}
    means["_timing"] = {k: round(v, 4) for k, v in timers.totals.items()}
    means["_graph_replays"] = train_step.graph_replays - replays0
    means["_eager_steps"] = train_step.eager_steps - eager0
    return means


def evaluate(eval_step, dataset, sampler, device, feats_dtype, pad_to: int = 1):
    """Validation pass with a weighted eval step (per-batch sums over real
    rows plus the row count), drained once at the end; batches padded to
    `pad_to` rows (the data axis). Under several processes the per-batch
    sums are summed over them first, so every rank gets the dataset's exact
    means."""
    timers = PhaseTimers()
    pending: list = []
    n = 0
    timers.start("data")
    for batch in _batches(dataset, sampler, device, feats_dtype, with_weights=True,
                          pad_to=pad_to):
        timers.stop("data")
        timers.start("step")
        pending.append(eval_step(batch))
        timers.stop("step")
        n += 1
        timers.start("data")
    timers.stop("data")
    timers.start("drain")
    totals = {"loss": 0.0, "l3d": 0.0, "mpjpe": 0.0, "bone": 0.0, "n": 0.0}
    if data_info()[1] > 1 and pending:
        sums = sum_across_processes(
            torch.stack([torch.stack([m[k].float() for k in totals]) for m in pending]))
        pending = [dict(zip(totals, row)) for row in sums]
    _drain(pending, totals)
    rows = totals.pop("n")
    timers.stop("drain")
    _log("[Val timing]\n" + timers.summary(n), flush=True)
    if rows == 0.0:
        # zero-row averages would read as val MPJPE 0.000, a fake new best
        _log("WARNING: the val sampler yielded ZERO rows — check val "
             "subjects / batch size against the store; val metrics are inf "
             "this epoch and no 'best' checkpoint will be saved.", flush=True)
        out = {k: float("inf") for k in totals}
    else:
        out = {k: v / rows for k, v in totals.items()}
    out["_timing"] = {k: round(v, 4) for k, v in timers.totals.items()}
    return out


def _append_metrics(outdir, record: dict) -> None:
    # inf/nan would print as non-RFC JSON tokens: write null
    record = {k: (None if isinstance(v, float) and not math.isfinite(v) else v)
              for k, v in record.items()}
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")


def check_feature_width(cfg: TrainConfig, *stores) -> None:
    """Raise where a store's features are not --model.feature-dim wide
    (ResNet-50 writes 2048, ViT-H 1280): the input projection would
    otherwise fail deep in the first step."""
    for store in stores:
        width = getattr(store, "feature_dim", None)
        if width is not None and width != cfg.model.feature_dim:
            raise ValueError(
                f"{getattr(store, 'root', 'the store')} holds {width}-wide features "
                f"but --model.feature-dim is {cfg.model.feature_dim}: train with "
                f"--model.feature-dim {width} (the extraction backbone's width)")


def fit(cfg: TrainConfig, train_set, val_set, train_sampler, val_sampler,
        mesh: Optional[Mesh] = None, device=None):
    """Full training run (h36x's signature: `mesh` None chooses one by
    h36x's rules, :func:`check_supported`, over this process's local
    devices, :func:`h36x_torch.utils.runtime.local_devices` of `device`
    (cuda unless the caller asks for another) and --dist.local-devices;
    or the given mesh, e.g. `make_mesh(2, 1, devices=[cuda0, cuda0])`),
    this process's part of a run over the process group when there is one
    (--dist.num-processes, joined by
    :func:`h36x_torch.parallel.distributed.setup_from_config`); returns
    (model, best_val). The model lives on the first local device; under
    tensor parallelism over processes it holds this process's slices
    (`model.tp`)."""
    check_feature_width(cfg, train_set, val_set)
    rank, processes = process_info()
    if processes != max(1, cfg.dist.num_processes):
        raise ValueError(f"--dist.num-processes {cfg.dist.num_processes} but the "
                         f"process group holds {processes} (setup_from_config "
                         "joins it)")
    if mesh is None:
        if device is None and process_devices()[0] is not None:
            devices = process_devices()  # setup_from_config's
        else:
            devices = local_devices(device, cfg.dist.local_devices
                                    if resolve_device(device).type == "cpu" else 0)
        mesh = check_supported(cfg, devices)
    else:
        _check_config(cfg)
        check_mesh(cfg, mesh)
    main = rank == 0
    groups = mesh.local_groups(rank)
    device = groups[0][0]
    o = cfg.optim
    phase = o.phase
    init_groups(mesh)
    model = build_model(cfg, device, torch.Generator().manual_seed(o.seed))
    if cfg.init_from:
        model.load_state_dict(ckpt.load_params_only(cfg.init_from, model.state_dict()))
        _log(f"Initialized model weights from {cfg.init_from}")
    if mesh.model > 1:
        tp = (shard_model(model, mesh) if len(groups[0]) == 1
              else shard_local(model, mesh, groups[0]))
        _log(f"mesh: data={data_axis_size(mesh)}, model={mesh.model}; "
             f"{len(tp.dims)} params split over the model axis")
    elif len(groups) > 1:
        _log(f"mesh: data={data_axis_size(mesh)} ({len(groups)} local devices"
             + (f" x {processes} processes)" if processes > 1 else ")"))
    optimizer, _ = make_optimizer(model, o.lr, o.weight_decay, freeze_ar=o.freeze_ar,
                                  phase=phase if phase != 1 else None)
    replicas = Replicas(model, groups) if len(groups) > 1 else None
    if phase == 2:
        if o.fused:
            # no fused phase-2 step exists; training the plain path while the
            # user believes they chose the kernels would mislead any timing
            raise ValueError(
                "--optim.fused only implements the phase-1 step; "
                "phase 2 (f_AR curriculum) trains on the plain PyTorch path — "
                "drop the flag")
        train_step = make_future_train_step(
            model, optimizer, input_len=o.input_len, pred_len=o.pred_len,
            lambda_joints=o.lambda_future, scan_steps=o.steps_per_dispatch,
            accum_steps=o.grad_accum, replicas=replicas)
        # score the AR path: the plain eval reads only modules phase 2
        # freezes, so its metric would be constant and early-stop blindly
        eval_step = make_weighted_future_eval_step(
            model, input_len=o.input_len, pred_len=o.pred_len,
            lambda_joints=o.lambda_future, replicas=replicas)
    else:
        train_step = make_train_step(
            model, optimizer, fused=o.fused, lambda_2d=o.lambda_2d,
            scan_steps=o.steps_per_dispatch, accum_steps=o.grad_accum,
            replicas=replicas)
        eval_step = make_weighted_eval_step(model, use_kernels=o.fused,
                                            replicas=replicas)
    pad_to = data_axis_size(mesh)
    feats_dtype = feed_dtype(cfg.data.feed_dtype)
    save = (ckpt.save_checkpoint_orbax if cfg.ckpt_backend == "orbax"
            else ckpt.save_checkpoint)
    # msgpack: rank 0 writes one file. orbax: every process calls the save,
    # as h36x's collective one (a tensor-parallel model gathers there)
    write_ckpt = cfg.ckpt_backend == "orbax" or main

    start_epoch = 0
    best_val = float("inf")
    no_improve = 0
    steps = 0
    if cfg.resume:
        manifest = ckpt.load_checkpoint(cfg.resume, "last", model, optimizer)
        start_epoch = manifest["epoch"] + 1
        best_val = manifest["best_val"]
        steps = manifest["step"]
        # the early-stop patience too: without it a resumed run would
        # tolerate up to `patience` more non-improving epochs
        no_improve = int(manifest.get("no_improve", 0))
        _log(f"Resumed from {cfg.resume} (epoch={start_epoch}, "
             f"best={best_val:.4f}, no_improve={no_improve})")
    cfg_json = dataclasses.asdict(cfg)
    # dropout masks of an epoch come from this generator reseeded by (seed,
    # epoch), not a stream carried across epochs: a resumed run draws what
    # the uninterrupted one drew. One object for the run, as a captured
    # train step reads the generator it was captured with.
    gen = torch.Generator(device=device)

    for epoch in range(start_epoch, o.epochs):
        train_sampler.set_epoch(epoch)
        lr = cosine_lr(epoch, o.lr, o.epochs)
        set_learning_rate(optimizer, lr)
        horizon = None
        if phase == 2:
            horizon = curriculum_horizon(epoch, o.pred_len, o.curriculum_steps)
            _log(f"\nEpoch {epoch+1}/{o.epochs} (lr {lr:.2e}, AR horizon "
                 f"{horizon})", flush=True)
        else:
            _log(f"\nEpoch {epoch+1}/{o.epochs} (lr {lr:.2e})", flush=True)
        t0 = time.perf_counter()
        gen.manual_seed(o.seed * 1_000_003 + epoch)
        tp_before = dict(model.tp.stats) if model.tp is not None else {}
        with maybe_trace(cfg.profile_dir if epoch == start_epoch else None, device):
            tr = train_epoch(train_step, train_set, train_sampler, device,
                             feats_dtype, gen, log_every=o.log_every,
                             horizon=horizon, pad_to=pad_to)
        steps += tr["_graph_replays"] * train_step.scan_steps + tr["_eager_steps"]
        # the bytes the model group's collectives moved in the train pass
        tp_train = {f"tp_train_{k}": model.tp.stats[k] - v for k, v in tp_before.items()}
        va = evaluate(eval_step, val_set, val_sampler, device, feats_dtype, pad_to)

        _log(f"Train: loss={tr['loss']:.6f}"
             + (f" (2d {tr['l2d']:.6f})" if tr.get("l2d") else "")
             + (f" (ar {tr['l_ar']:.6f})" if tr.get("l_ar") else "")
             + f" | mpjpe={tr['mpjpe']:.3f}\n"
             f"Val:   loss={va['loss']:.6f} (3d {va['l3d']:.6f}) | mpjpe={va['mpjpe']:.3f}\n"
             f"Epoch time: {time.perf_counter()-t0:.2f}s", flush=True)

        # `best` commits before `last`, so a crash between the two saves
        # never pairs a new best_val with stale best params
        improved = (best_val - va["mpjpe"]) > o.early_stop_min_delta
        t_save = time.perf_counter()
        if improved:
            best_val = va["mpjpe"]
            no_improve = 0
            if write_ckpt:
                save(cfg.outdir, "best", model, optimizer, epoch, best_val, steps,
                     cfg_json)
        else:
            no_improve += 1
        if write_ckpt:
            save(cfg.outdir, "last", model, optimizer, epoch, best_val, steps, cfg_json,
                 extra={"no_improve": no_improve})
        t_save = time.perf_counter() - t_save
        if main:
            _append_metrics(cfg.outdir, {
                "epoch": epoch,
                "lr": lr,
                "train_loss": tr["loss"],
                "train_mpjpe": tr["mpjpe"],
                "val_loss": va["loss"],
                "val_mpjpe": va["mpjpe"],
                "val_bone": va.get("bone"),
                "epoch_seconds": time.perf_counter() - t0,
                "train_data_s": tr["_timing"].get("data"),
                "train_step_s": tr["_timing"].get("step"),
                "train_drain_s": tr["_timing"].get("drain"),
                "val_data_s": va["_timing"].get("data"),
                "val_step_s": va["_timing"].get("step"),
                "val_drain_s": va["_timing"].get("drain"),
                "graph_replays": tr["_graph_replays"],
                "eager_steps": tr["_eager_steps"],
                "ckpt_save_s": t_save,
                **tp_train,
            })

        if improved:
            _log(f"New best val MPJPE: {best_val:.3f} (saved best)")
        else:
            _log(f"No improvement for {no_improve}/{o.early_stop_patience} "
                 f"epochs (best {best_val:.3f}, current {va['mpjpe']:.3f})")
        if o.early_stop_patience > 0 and no_improve >= o.early_stop_patience:
            _log(f"Early stopping at epoch {epoch+1}. Best val MPJPE: {best_val:.3f}")
            break
        if o.stop_after_epochs > 0 and epoch - start_epoch + 1 >= o.stop_after_epochs:
            _log(f"Stopping after {o.stop_after_epochs} epoch(s) this run "
                 f"(--optim.stop-after-epochs; schedule targets {o.epochs} — "
                 "resume with --resume to continue the exact trajectory)")
            break

    _log(f"\nDone. Best val MPJPE: {best_val:.3f}")
    return model, best_val
