"""Training cells: PHD phase 1 through the trainer's own epoch loop.

Set-up writes a float32 feature store made from the seed into the run's
directory (the program's shard format), builds what `fit` builds (the
model, AdamW, the train step, the dataset and its sampler), loads weights
made from the seed on the card, and runs epoch 0 through
`train.loop.train_epoch`, which warms every shape; a probe on the step
reads the first three steps' losses, the first gradient (from AdamW's
first moment) and the parameters' change after step 3. The window runs
epochs 1, 2, ... back to back, each as `fit` runs it (sampler epoch,
cosine learning rate, dropout generator reseeded), until the window's
seconds have passed; the last epoch runs to its end.

After the window the plain reference (portbench/reference/phd.py) makes
the weights and rows again from the seed, takes the first three batches of
the frozen sampler rule and the dropout masks of the frozen draw rule from
a generator seeded as the program's, and follows the three steps in
float32. Compared, each as the widest relative gap: the three losses, the
first gradient's norm per parameter and the change's norm per parameter.
"""

from __future__ import annotations

import statistics
import time

import torch

from portbench import rules, synth, trace
from portbench.harness import Outcome, Run
from portbench.reference import phd as ref_phd
from portbench.roofline import phd_train_step_units, total_bound_s, total_flops

PROBE_STEPS = 3
# a parameter whose reference gradient is under this share of the median
# parameter's moves under AdamW by round-off alone: its change is not compared
STILL = 1e-3


class Probe:
    """The train step, reading the optimizer after steps 1 and 3."""

    def __init__(self, step, optimizer, names: dict, w0: dict):
        self.step, self.optimizer, self.names, self.w0 = step, optimizer, names, w0
        self.calls, self.losses = 0, []
        self.grad_norms, self.change_norms = {}, {}

    def __getattr__(self, key):
        return getattr(self.step, key)

    def __call__(self, batch, generator=None):
        out = self.step(batch, generator)
        self.calls += 1
        if self.calls <= PROBE_STEPS:
            self.losses.append(float(out["loss"]))
        params = self.optimizer.param_groups[0]["params"]
        if self.calls == 1:
            c1 = (1 - self.optimizer.hyper["b1"]).double()
            for p in params:
                mu = self.optimizer.state[p]["mu"]
                self.grad_norms[self.names[id(p)]] = float(mu.double().norm() / c1)
        if self.calls == PROBE_STEPS:
            for p in params:
                n = self.names[id(p)]
                self.change_norms[n] = float((p.detach().double() - self.w0[n].double()).norm())
        return out


def train_config(run: Run):
    from h36x_torch.config import TrainConfig

    cfg, spec = run.cell.config, run.cell.spec
    tc = TrainConfig()
    for k in ("latent_dim", "feature_dim", "joints_num", "num_blocks", "ar_num_blocks",
              "regressor_iters", "regressor_hidden", "dropout", "groups", "kernel_size"):
        setattr(tc.model, k, cfg[k])
    tc.model.dtype = cfg["train_dtype"]
    tc.data.seq_len = cfg["seq_len"]
    tc.optim.batch_size = cfg["batch_size"]
    tc.optim.fused = bool(spec["fused"])
    tc.optim.seed = synth.sub_seed(run.seed, "sampler")
    return tc


def write_store(run: Run) -> str:
    from h36x_torch.data.shards import shard_path, write_index, write_shard

    cfg, spec = run.cell.config, run.cell.spec
    root = run.workdir / "store"
    root.mkdir()
    shards, clips, nv = spec["shards"], cfg["shard_size"], spec["variants"]
    for s in range(shards):
        rows = synth.clip_rows(cfg, run.seed, s, clips, nv, run.device)
        arrays = {k: v.cpu().numpy() for k, v in rows.items()}
        del rows
        write_shard(shard_path(root, s), arrays, [{} for _ in range(clips * nv)], nv)
    write_index(root, synth.store_layout(shards, clips, nv), n_shards=shards,
                n_clips=shards * clips, n_variants=nv,
                aug_names=[f"v{i}" for i in range(nv)], seq_len=cfg["seq_len"],
                frame_skip=2, feat_dtype="float32")
    return str(root)


def dropout_seed(run: Run, epoch: int) -> int:
    return synth.sub_seed(run.seed, "dropout", epoch)


def run(run: Run) -> Outcome:
    from h36x_torch.data.features import FeatureClipDataset
    from h36x_torch.data.sampler import MixedShardBatchSampler
    from h36x_torch.parallel.feed import feed_dtype
    from h36x_torch.train.loop import build_model, train_epoch
    from h36x_torch.train.state import cosine_lr, make_optimizer, set_learning_rate
    from h36x_torch.train.step import make_train_step

    cfg, dev = run.cell.config, run.device
    cuda = dev.type == "cuda"
    tc = train_config(run)
    o = tc.optim
    store = write_store(run)
    phases = {"store_written": time.perf_counter() - run.t_start}
    model = build_model(tc, dev)
    w0 = synth.phd_weights(cfg, run.seed, dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w0[name])
    optimizer, _ = make_optimizer(model, o.lr, o.weight_decay, freeze_ar=o.freeze_ar)
    step = make_train_step(model, optimizer, fused=o.fused, lambda_2d=o.lambda_2d,
                           scan_steps=o.steps_per_dispatch, accum_steps=o.grad_accum)
    dataset = FeatureClipDataset(store, subjects=[1], augment=tc.data.augment,
                                 shard_cache_size=64)
    sampler = MixedShardBatchSampler(dataset, o.batch_size, shuffle=True, drop_last=True,
                                     seed=o.seed)
    gen = torch.Generator(device=dev)
    feeds = feed_dtype(tc.data.feed_dtype)

    def epoch(e, train_step):
        sampler.set_epoch(e)
        set_learning_rate(optimizer, cosine_lr(e % o.epochs, o.lr, o.epochs))
        gen.manual_seed(dropout_seed(run, e))
        return train_epoch(train_step, dataset, sampler, dev, feeds, gen, log_every=0)

    names = {id(p): n for n, p in model.named_parameters()}
    phases["model_built"] = time.perf_counter() - run.t_start
    probe = Probe(step, optimizer, names, w0)
    epoch(0, probe)
    del w0, probe.w0
    steps_per_epoch = len(sampler)
    launches0 = _launches()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    setup_s = t0 - run.t_start
    e, steps, data_wait, bad = 1, 0, 0.0, 0
    tr = None
    while True:
        if run.trace and tr is None:
            tr = trace.Trace(run.workdir / "trace.json", cuda)
            with tr:
                res = epoch(e, step)
            traced_steps = steps_per_epoch
        else:
            res = epoch(e, step)
        steps += steps_per_epoch
        data_wait += res["_timing"].get("data", 0.0)
        bad += 0 if res["loss"] == res["loss"] else steps_per_epoch
        e += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = {k: v - launches0[k] for k, v in _launches().items()}
    if tr is not None:
        tr.finish()
    lr0 = cosine_lr(0, o.lr, o.epochs)
    prog = (probe.losses, probe.grad_norms, probe.change_norms)
    del model, optimizer, step, dataset, sampler, probe
    if cuda:
        torch.cuda.empty_cache()

    checks = compare(run, tc, prog, lr0)
    units = phd_train_step_units(cfg, o.batch_size)
    record = {"window_s": window_s, "data_wait_s": data_wait}
    if tr is not None:
        record.update(traced_window_s=tr.host_s,
                      traced_flops=traced_steps * total_flops(units),
                      traced_bound_s=traced_steps * total_bound_s(units))
    return Outcome(
        setup_s=setup_s,
        e2e={"train_clips_per_s": steps * o.batch_size / window_s},
        record=record, attempted=steps, failed=bad, checks=checks,
        memory_peak_bytes=peak, trace=tr.summary if tr is not None else None,
        proof={"steps": steps, "epochs": e - 1, "launches": launches,
               "setup_phases_s": phases})


def _launches() -> dict:
    from h36x_torch.ops.regressor import fused_joint_regressor, joint_regressor_bwd
    from h36x_torch.ops.temporal import fused_gn_relu_cconv, gn_relu_cconv_bwd

    return {"B1": fused_gn_relu_cconv.launches, "B2": gn_relu_cconv_bwd.launches,
            "B3": fused_joint_regressor.launches, "B4": joint_regressor_bwd.launches}


def reference_readings(run: Run, tc, lr: float):
    """The reference's three steps: (losses, first gradient's norms, the
    change's norms), per parameter, in float32."""
    cfg, dev, o, spec = run.cell.config, run.device, tc.optim, run.cell.spec
    shards, clips, nv = spec["shards"], cfg["shard_size"], spec["variants"]
    per_clip = nv if tc.data.augment else 1
    n_items = shards * clips * per_clip
    buckets: dict = {}
    for i in range(n_items):
        buckets.setdefault(i // (clips * per_clip), []).append(i)
    batches = []
    for b in rules.sampler_batches(buckets, o.batch_size, min(4, shards), o.seed):
        batches.append(b)
        if len(batches) == PROBE_STEPS:
            break
    rows = [synth.clip_rows(cfg, run.seed, s, clips, nv, dev) for s in range(shards)]

    def gather(idx):
        pick = [(i // (clips * per_clip), (i % (clips * per_clip)) // per_clip * nv
                 + i % per_clip) for i in idx]
        feats = torch.stack([rows[s]["feats"][r] for s, r in pick])
        joints = torch.stack([rows[s]["joints3d"][r] for s, r in pick]) / 1000.0
        return feats, joints

    data = [gather(b) for b in batches]
    del rows
    names = ref_phd.trainable(cfg)
    w = synth.phd_weights(cfg, run.seed, dev)
    w0 = {n: w[n].clone() for n in names}
    adam = ref_phd.AdamW(w, names, lr, o.weight_decay)
    gen = torch.Generator(device=dev).manual_seed(dropout_seed(run, 0))
    keep = 1.0 - cfg["dropout"]
    mask = (lambda shape: rules.dropout_mask(shape, keep, gen, dev)) if keep < 1.0 else None
    # float32 whatever the process has set: a control may run the program's
    # side in TF32 around this comparison
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        losses, grad_norms = [], {}
        for i, (feats, joints) in enumerate(data):
            loss, grads = ref_phd.loss_and_grads(w, names, feats, joints, cfg, mask)
            losses.append(float(loss))
            if i == 0:
                grad_norms = {n: float(grads[n].double().norm()) for n in names}
            adam.step(grads)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    change = {n: float((w[n].double() - w0[n].double()).norm()) for n in names}
    return losses, grad_norms, change


def gaps(prog, ref) -> dict:
    """The widest relative gaps between two readings (losses, gradient
    norms, change norms): a loss against the reference's, a parameter's
    norm against the larger of the reference's and the median parameter's;
    the change left out where the reference's gradient is under STILL of
    the median's."""
    (pl, pg, pc), (rl, rg, rc) = prog, ref
    loss = max(abs(a - b) / abs(b) for a, b in zip(pl, rl))
    med_g, med_c = statistics.median(rg.values()), statistics.median(rc.values())
    grad = max(abs(pg[n] - rg[n]) / max(rg[n], med_g) for n in rg)
    moved = [n for n in rc if rg[n] >= STILL * med_g]
    change = max(abs(pc[n] - rc[n]) / max(rc[n], med_c) for n in moved)
    return {"loss_gap": loss, "grad_norm_gap": grad, "change_norm_gap": change}


def compare(run: Run, tc, prog, lr: float) -> list:
    limits = run.cell.spec["limits"]
    got = gaps(prog, reference_readings(run, tc, lr))
    return [(k, got[k], limits[k]) for k in limits]
