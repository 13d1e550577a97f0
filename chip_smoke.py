#!/usr/bin/env python3
"""Drive the h36x_torch serving, training, feature-extraction and
prediction paths, the tools and the matmul probe once on one NVIDIA GPU
(H100).

    python3 chip_smoke.py

1. Setup: prints the card and its power limit, builds the six CUDA kernels
   from h36x_torch/ops/csrc/ (one nvcc per source, all started together)
   and logs ptxas's lines naming each kernel function, its registers and
   its spills.
2. Each kernel against its plain PyTorch version on the card (TF32 off), at
   the shapes of both paths and the edge cases, within the stated
   tolerance: the forward kernels B1 (temporal) and B3 (regressor) on both
   routes of the `precise` switch -- the precise route (FP32) against the
   float32 plain forward element-wise; the fast route (bf16 weights,
   activations as bf16 pairs, f32 sums, hopper.cuh's TMA + wgmma GEMM)
   against its own plain version (which rounds the same operands)
   element-wise and by relative norm,
   against the float32 plain forward by relative norm, and two runs bit for
   bit -- the backward kernels B2 and B4 against autograd of
   the plain forward (B2 at B 32, T 40, D = O 1024 with and without the
   residual and at T 1-4 and B 1; B4 at N 1280 and N 13, with tie-free
   weights and with init-scale weights, whose ReLU masks vary by row and
   round, on rows drawn clear of ReLU ties), element-wise and by relative
   norm, through the wrapper (the route the widths name: hopper, three
   bf16 parts and six tensor-core passes a product) and on each route
   (hopper and general, uncounted), each route twice and bit for bit, the
   hopper route also against its split plain version; then each one's
   time, its plain version's time and its bound (B1
   at B 16 / T 40, B 8 / T 52 strided and B 1 / T 40, B3 at N 640, 1 and
   200, on both routes, each beside the bound at its route's peak; B2 and
   B4 on both routes, the hopper route beside its bound with the products
   once and with its six passes, and each launch's device ms). B5,
   the fused ResNet bottleneck, at the shapes of the 13 stride-1 blocks at
   224 px (the projection block layer1_0 included), at N 1 and at the
   extraction dispatch size (480 frames), in float32 (element-wise) and
   bfloat16 (relative norm), and at odd sizes (9x9, 5x3), each on the route
   bottleneck_route picks (bfloat16 stage shapes: the hopper route, TMA +
   wgmma; float32 and odd widths: the general route), the per-route counts
   checked; timed per shape in bfloat16 at the dispatch size, beside the
   general route's time on the same inputs (the earlier, mma.sync design).
   B1 also at the rollout's and the stream's shapes (B 8, every T from 40
   to 64 as the prefix of a longer buffer, strided and dense, bit for bit
   on both routes; B 1 at T 20 and 40), B3 also at N 1, 13, 200 and 1280.
   B6, the tiled matmul probe, at 4096^3 and at 256 x 1024 x 512 with every
   compiled tile, int8 bit for bit and bfloat16 by relative norm; its time
   per mode and tile beside torch.matmul's and torch._int_mm's, its bound
   and, for int8, the transposition's share.
3. One full-width phase-1 step (batch 32), fused against plain: loss and
   every gradient leaf (by relative norm at the seeded init; element-wise
   and by relative norm on tie-free parameters), at dropout 0 (all four
   kernels launch, B2 and B4 on the hopper route) and 0.5 (the same masks
   both sides); the step's time both ways. The full ResNet-50 at 224 px on
   480 u8 frames, the folded
   `opt` engine (13 B5 launches, all on the hopper route) against the
   plain module (cuDNN), both bfloat16, and each against the float32
   module, by relative norm; each engine's frames/s. The grouped step
   (`--optim.steps-per-dispatch 4`) at full width: the first group eager
   and captured as one CUDA graph of 4 fused steps (forward, B1-B4,
   AdamW); one replay against the same 4 steps run eagerly, params, mu,
   nu, count and metrics bit for bit, no wrapper count during the replay,
   and the replay's torch.profiler trace holding the eager group's B1-B4
   kernels; set_learning_rate between two replays reaching the second
   (equal to eager steps at the new rate); at dropout 0.5 two replays of
   one batch drawing other masks; ms per step eager and graphed.
4. The serving path at full model width: a seeded PHDFor3DJoints is saved
   as a checkpoint, served by the port's BatchingServer on a local socket,
   precise and then at its default (fast), and answers 16 concurrent and 3
   sequential (40, 2048) requests and a stats query each time; the precise
   replies are held against the float32 plain forward of their rows
   (E2E_TOL), the fast ones by relative norm against the fast plain
   forward and the float32 one; the counts must show 4 temporal and 1
   regressor launches per device batch. phd_forward_fused(predict_future=
   True) with kernels is held against its plain version too (f_AR and the
   second regressor pass), in both modes.
   Export and the daemon's artifact mode at the same width: h36x_torch.cli.
   export writes the forward at float32 (with --check) and bfloat16 and the
   25-step rollout from one seeded checkpoint (each one's seconds and file
   size); each artifact is loaded onto the card (every constant there) and
   called at batch 1, 5, 16 and 32: the f32 forward against the float32
   plain engine and the precise kernel engine (E2E_TOL), the bf16 one within
   2e-2 of it, the rollout against make_rollout_fn(use_kernels=False); each
   is served by BatchingServer in artifact mode (bucket padding; 8 bursts of
   16 concurrent requests, 3 sequential ones, a stats query; the rollout's
   replies split) against the artifact called directly, with no kernel
   launched; checkpoint mode, precise and fast, serves the same requests,
   and the five modes' device ms per batch (p50/p99) are logged side by
   side with the card's name and power limit.
5. The training path: a full-width 192-clip store (T 40, feature 2048;
   128 train clips, 4 batches an epoch, 64 val) written with the port's
   ShardWriter, trained for 2 epochs by h36x_torch.cli.train.main with
   --optim.fused true --model.dropout 0 at batch 32; finite losses,
   best/last checkpoints (last equal to the trained model), 2
   metrics.jsonl lines, and exactly 4 B1 + 4 B2 + 1 B3 + 1 B4 launches per
   train step and 4 B1 + 1 B3 per eval batch. Then, each its own path on
   that store: --optim.steps-per-dispatch 4 (epoch 1 eager and captured,
   epoch 2 one replay; metrics.jsonl within 1e-6 of the ungrouped run);
   --optim.grad-accum 2 for one epoch with --profile-dir (finite, a trace
   holding B1-B4's kernels); --optim.stop-after-epochs 1 then --resume
   (rows equal to the uninterrupted run's); phase 2 --init-from the
   phase-1 best for 2 epochs, --optim.curriculum-steps 2 (finite,
   input_proj, f_movie and f_3D bit for bit unchanged, f_AR moved; plain
   ops, no launch). Then --model.dtype bfloat16: one plain step of a bf16
   and an f32 model from one seed on the store's first 32 clips (the bf16
   loss float32, within 2e-2 of f32's), ms per full train step plain bf16,
   plain f32 and fused f32 at batch 32; cli.train --model.dtype bfloat16
   plain for one epoch (finite, no launch); and with --optim.fused true for
   2 epochs: its steps launch B1-B4 as the f32 fused run's and give its
   train losses exactly (the kernels compute in float32 whatever the dtype,
   as h36x's fused step), its eval in bf16 plain ops (as h36x's model.apply).
   Then data-parallel (train_dist): the same 2-epoch fused run in two
   processes on the one card (this script again, as --train-worker REPORT
   ARGS, around cli.train.main with --dist.num-processes 2 --dist.collectives
   gloo: 16 rows each, gradients averaged through the host), the first
   step's loss within LOSS_TOL of a one-process worker's and every step's
   and rank 0's metrics.jsonl rows within DIST_ROW_TOL of one process's
   (h36x's keys and bound for its 2-process rows), rank 1 writing
   no file, each rank's B1-B4 counts those of the single-process run, step
   ms per rank beside the single process's; a 2-process stop after 1 epoch
   and --resume equal to the straight 2-process run; and NCCL (the default
   on CUDA) refusing two ranks on one card by name. The control of the
   2-process rows (train_dist_control): one process (this script as
   --control-worker REPORT ARGS), the same store, init and flags, each
   update made from the fused step's gradients of rows 0-15 and 16-31
   taken separately and averaged as the all-reduce averages them: its loss
   at every step beside the 2-process run's and the one process's, within
   CONTROL_TOL of the 2-process run (bit for bit logged), its rows and
   final params compared too. Then orbax checkpoints and tensor
   parallelism (drive_orbax_tp_path) on the same store: the fused run with
   --ckpt-backend orbax (B1-B4 as the msgpack run; rows and `last` equal
   the msgpack run's bit for bit; stop + --resume from orbax equal to the
   straight run), save / load seconds of the flagship state per backend
   and the zstd decoder's MB/s (checkpoint_timing); 2 processes on the one
   card over gloo with --mesh.model 2 (plain step, no kernel) against the
   one-process plain run (first step at LOSS_TOL, every step and h36x's
   row keys at DIST_ROW_TOL, rank 1 writing nothing, ms per step per rank,
   bytes all-gathered and all-reduced per step), a resumed pair equal to
   the straight TP run; the TP run's orbax `best` served through
   make_fused_forward(precise=True) (4 B1 + 1 B3, E2E_TOL against the
   plain engine) and converted by cli.convert --to-torch-ckpt (the bytes of
   a msgpack save's); the golden orbax directory h36x wrote
   (tests/golden/orbax_v1) read bit for bit against its npz.
6. The extraction path: h36x_torch.extract.pipeline.run_extract (what
   h36x_torch.cli.extract calls) over an in-memory video source made from a
   seed (SyntheticVideos: the machine has no OpenCV to decode mp4), at the
   traffic of EXTRACT (1000x1000 frames, seq_len 40, stride 5, 224 px, the
   4 variants, the unique-frame scheduler's production profile, the port's
   native crop library), once with --engine opt and once with flax:
   exactly 13 B5 launches per dispatch and none with flax; both stores pass
   verify_store, index.json and every non-feature array are byte-identical
   between them, the features finite and within the bf16 tolerance; one
   batch of the store runs through the PHD forward. Clips/s of each run.
   Then ingest: a raw Human3.6M tree this script writes from a seed
   (metadata.xml with the w0 block and the action mapping; 1 subject x 2
   actions x 2 trials x the 4 official cameras; npz poses of 1000 frames x
   32 joints; stub mp4s) through h36x_torch.cli.ingest.main: 16 cells, the
   pickles equal to the npz poses at H36M_RAW_JOINT_IDS, rt orthonormal,
   the symlinks, a second run changing no file. The crop-resize front ends
   (crop_resize) at one clip of 40 1000x1000x3 u8 frames on the card cropped
   to 224: matrix and gather forms against the CPU, each other (1e-5) and
   the native crop (one u8 step), resize_bilinear against F.interpolate,
   ms per clip. Partitioned extraction (extract_partitioned) of the
   ingested tree's clips (frames from memory): --engine opt unpartitioned
   and as --partition 0/2 and 1/2 (exact B5 counts each),
   h36x_torch.cli.merge_shards --verify --keep-parts, the merged store
   holding every clip of the unpartitioned run once (joints and K equal,
   features within 2e-2; bit for bit logged), and a bf16 and a reference
   .pt copy of it read back through FeatureClipDataset and fed to the card
   in every --data.feed-dtype.
   Then the tools (drive_tools_path), at the flagship width: a reference
   PHD checkpoint (a torch copy of the reference's module, from a seed) and
   an NPZ of its float32 predictions on 32 x 40 seeded features;
   cli.convert --torch-ckpt and --to-torch-ckpt back (the state_dict bit
   for bit); cli.parity with --torch-ckpt and with --ckpt (PASS at 0.1 mm,
   exactly 4 B1 + 1 B3 each, the forward's device ms), and with the
   predictions shifted 0.5 mm at one joint (must exit 1); parity --full
   (run_full with the ingested tree's frames from memory: no OpenCV
   there) extracting with a seeded torchvision-layout ResNet-50 (13 B5 a
   dispatch, then 4 B1 + 1 B3), then PASS against the reference module's
   predictions on the extracted features; cli.doctor with --root,
   --verify-store, --ckpt, --artifact (the f32 artifact of the export
   phase) and --dedup-estimate, exit 0 with the six kernels ready.
7. The prediction path at full width, on a store that write_store makes
   and a seeded checkpoint: h36x_torch.cli.predict.main in its three modes
   (batch rollout of 8 clips x 25 steps; --streaming --freeze with a
   25-step forecast; --forecast 0), precise (each NPZ held against the same
   call with the plain engines at E2E_TOL, future frames included) and at
   its default, fast (by relative norm against the plain engines in fast
   mode and in float32), with exact launch counts: a rollout 4 + 150 B1
   and 2 B3, an exact push 4 B1 + 1 B3, the first frozen push 1 B3 (eager,
   before the capture), every later one none through the wrappers (one
   replay of the captured step: the predictor's `replays` counts it, and a
   profiler trace of replays shows exactly B3's kernels once a push and no
   B1 kernel), a forecast 4 + 150 B1 and 1 B3. Then one predictor
   by hand per mode (exact pushes, a forecast, the freeze, frozen pushes, a
   forecast) against the plain engines, and ms per rollout and per push
   (exact and frozen, medians; the frozen push must be the faster) and per
   forecast on both routes, evaluate_test over the store (precise, against
   the plain eval) and dump_debug_batch. h36x_torch.cli.results as a whole
   re-decodes mp4 clips, for which that machine has no OpenCV: its whole run
   is the CPU test's (tests/test_torch_results.py).
8. The matmul probe's own entry point, h36x_torch.benchmarks.
   int8_kernel_probe.main, once (B6's main path).
9. Prints one {"kernels": [...]} line (launches: every path's run), then
   the card's name and power limit, then the last line
   {"ok": true, "device": {...}}.

Any failure raises and exits nonzero; without CUDA it exits nonzero at once.
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_F32_FLOPS = 67e12  # H100 SXM FP32 outside the tensor cores (data sheet)
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 dense tensor cores (data sheet)
PEAK_INT8_OPS = 1979e12  # H100 SXM int8 dense tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth (data sheet)
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)  # FP32 both sides; sums reordered
E2E_TOL = dict(rtol=1e-3, atol=1e-4)  # full forward (tests/test_pallas.py)
# The fast routes (precise=False: bf16 weights, activations as bf16 pairs,
# f32 sums). A fast kernel against its fast plain version, which rounds the
# same operands: element-wise FAST_TOL and by relative norm FAST_REL_NORM;
# against the float32 plain version by relative norm F32_REL_NORM (bf16
# weights: about 2^-9 relative each)
FAST_TOL = dict(rtol=1e-3, atol=1e-4)
FAST_REL_NORM = 1e-4
F32_REL_NORM = 2.0 ** -8
# a path in fast mode against the same call with the plain engines in the
# same mode, and against the float32 plain path (the error of bf16 weights
# compounded over the blocks, the regressor's rounds and a rollout's steps)
PATH_REL_NORM = 1e-3
PATH_F32_REL_NORM = 2.0 ** -6
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)  # gradients (tests/test_pallas.py)
# |got - want| / |want| per gradient leaf: two FP32 summation orders of the
# same function agree to about 1e-6; a gradient that is dropped, misrouted
# or masked from the wrong row or round is off by O(0.1-1)
REL_NORM_TOL = 1e-4
# the same at the seeded init of the full step, where the ReLU masks vary by
# row and a few of the step's 13 M ReLU inputs lie so close to 0 that the two
# FP32 orders flip them: each flip moves its leaf by about
# 1/sqrt(rows * units), some 1e-3, of its norm
SEEDED_REL_NORM_TOL = 1e-2
LOSS_TOL = dict(rtol=1e-5, atol=0.0)  # fused vs plain step loss
# a 2-process run against one process's. The first step starts from the same
# params: only the batch split's rounding (each process's kernels reduce 16
# rows where one process's reduce 32) parts the losses, held at LOSS_TOL.
# Later steps: AdamW's first updates (m / sqrt(v) = sign(g)) turn that
# rounding into whole steps on near-zero gradients, so every step's loss and
# the metrics.jsonl rows are held at h36x's bound for its 2-process CLI rows
# (tests/test_multiprocess.py:172-174), on the keys it compares there;
# val_bone, a squared difference of bone lengths that magnifies the drift,
# is logged. The control run (check_split_control, on every call) shows
# this cause: one process making each update from the two 16-row blocks'
# gradients, averaged as the all-reduce averages them, equals the 2-process
# run bit for bit (every step's loss, the train rows, the final params) and
# parts from the one-process run exactly as it does (on an NVIDIA H100 80GB
# HBM3, 700 W: val_bone 5.3e-5, val_loss 1.6e-5, step losses up to 2.0e-5).
DIST_ROW_TOL = 1e-4
DIST_ROW_KEYS = ("lr", "train_loss", "train_mpjpe", "val_loss", "val_mpjpe")
# the control against the 2-process run, per step: the same arithmetic (each
# block's kernels on 16 rows, the blocks' gradients summed in float32 and
# halved), so equal bit for bit; the bound leaves room for float32
# summation noise only
CONTROL_TOL = 1e-6
# the backward kernels' hopper routes: each float32 operand split into three
# bf16 parts, six tensor-core passes a product
SPLIT_PASSES = 6
# B5 in bfloat16 against its plain version: both sum the same bf16 products
# in f32 in another order, so `a`, `b` and the output round to a
# neighbouring bf16 value now and then; one bf16 ulp (2^-8 relative) bounds
# the relative norm
BF16_REL_NORM = 2.0 ** -8
# the whole bfloat16 ResNet-50 by relative norm, two engines or one against
# the float32 module: they round at other points (folded weights, cuDNN's
# own), compounded over 16 blocks to about 3e-3 to 7e-3 (CPU, 64 and 224
# px); a wrong weight, block or pixel is off by O(1)
BACKBONE_REL_NORM = 2e-2

# the 13 stride-1 bottlenecks of ResNet-50 at 224 px: (blocks, how many of
# them, side, C_in, C_mid, C_out); layer1_0 is the projection block
B5_SHAPES = (("layer1_0", 1, 56, 64, 64, 256), ("layer1_1-2", 2, 56, 256, 64, 256),
             ("layer2_1-3", 3, 28, 512, 128, 512), ("layer3_1-5", 5, 14, 1024, 256, 1024),
             ("layer4_1-2", 2, 7, 2048, 512, 2048))
# the extraction traffic: H36M's 1000x1000 frames, clips of 40 subsampled
# frames at stride 5, 224 px crops, the 4 variants, the unique-frame
# scheduler in its production profile. Cut to size: 2 videos of 100
# subsampled frames (26 clips), and --batch-size 4 (480 backbone frames per
# dispatch, 3840 at the default 32) so that each engine runs 2 dispatches
EXTRACT = dict(videos=2, frames=100, raw=1000, seq_len=40, stride=5, resize=224,
               batch_size=4)


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def time_ms(fn, reps: int = 20) -> float:
    """Mean device ms of fn over `reps` back-to-back calls (CUDA events,
    after 3 warm-up calls; weights stay warm in L2 between calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(fn, launches: int, reps: int = 5):
    """Device ms of each kernel launch of one call of fn, in launch order,
    averaged over `reps` calls: the CUDA kernel events of a torch.profiler
    trace (CUPTI). One more call runs first inside the trace, where a first
    kernel the trace misses is lost; the last launches * reps events are
    read, and must repeat the call's kernels in order. A trace that fails
    this is taken again (at most 3 times), then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want = launches * reps
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        timed = kernels[-want:]
        names = [e.name for e in timed]
        if (len(kernels) >= want + launches - 1
                and all(n == names[i % launches] for i, n in enumerate(names))):
            return [sum(e.time_range.elapsed_us() for e in timed[i::launches]) / reps / 1e3
                    for i in range(launches)]
        log({"check": "launch_ms", "kernel_events": len(kernels),
             "want": want + launches})
    raise AssertionError(f"the profiler gave no trace of {launches} x {reps} kernels")


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| (Frobenius norms, in float64); inf for want = 0."""
    den = float(want.double().norm())
    return float((got - want).double().norm()) / den if den > 0 else float("inf")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol,
            rel_norm_tol=None) -> dict:
    """Log got against want and raise unless got is finite, within `tol`
    element-wise (rtol/atol; None: not checked) and, when `rel_norm_tol` is
    given, within it by relative norm."""
    torch.cuda.synchronize()
    err = (got - want).abs()
    rec = {"check": name, "shape": list(got.shape),
           "max_abs_err": float(err.max()),
           "max_rel_err": float(err.max() / want.abs().max().clamp_min(1e-30)),
           "max_abs_want": float(want.abs().max()),
           "rel_norm_err": rel_norm(got, want),
           "tol": tol, "rel_norm_tol": rel_norm_tol,
           "finite": bool(torch.isfinite(got).all())}
    ok = (rec["finite"] and (tol is None or torch.allclose(got, want, **tol))
          and (rel_norm_tol is None or rec["rel_norm_err"] <= rel_norm_tol))
    log(rec)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return rec


def uniform(shape, fan_in, g, device):
    b = 1.0 / fan_in ** 0.5
    return (torch.rand(shape, generator=g) * 2 * b - b).to(device)


def check_fast(name, got, again, want_fast, want_f32, quiet=False) -> float:
    """A fast route (precise=False) at one shape: two runs equal bit for bit
    (no atomics, no order that depends on the blocks' timing), within
    FAST_TOL and FAST_REL_NORM of
    its fast plain version, and within F32_REL_NORM of the float32 plain
    version by relative norm. Logs unless `quiet` (then only on failure);
    returns the max abs error against the fast plain version."""
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two runs of the fast route differ")
    err = float((got - want_fast).abs().max())
    rn, rn32 = rel_norm(got, want_fast), rel_norm(got, want_f32)
    ok = (bool(torch.isfinite(got).all()) and torch.allclose(got, want_fast, **FAST_TOL)
          and rn <= FAST_REL_NORM and rn32 <= F32_REL_NORM)
    if not quiet or not ok:
        log({"check": f"{name} fast", "shape": list(got.shape), "max_abs_err": err,
             "rel_norm_err": rn, "rel_norm_err_vs_f32": rn32, "tol": FAST_TOL,
             "rel_norm_tol": FAST_REL_NORM, "f32_rel_norm_tol": F32_REL_NORM,
             "run_to_run": "equal"})
    if not ok:
        raise AssertionError(f"{name}: the fast route disagrees with its plain version")
    return err


def host_ms(fn, reps: int = 20) -> float:
    """Host ms to issue one call of fn (no synchronisation inside the timed
    calls): what a call costs the CPU, against its device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def time_routes(kernel, plain, work, cuda_launches) -> dict:
    """Each route's kernel and plain times (kernel(precise), plain(precise)),
    its bound at its own peak (bf16 for the fast route, FP32 for the
    precise one) from work = (FLOPs, bytes per route, the fast route's
    issued FLOPs), the fast route's bound at the FLOPs it issues
    (`pair_bound_ms`: both halves of each bf16 pair), the kernel's CUDA
    launches per second of device time, the host ms to issue one call and
    each CUDA launch's device ms (profiler)."""
    flops, nbytes, issued = work
    out = {}
    for route, precise, peak in (("fast", False, PEAK_BF16_FLOPS),
                                 ("precise", True, PEAK_F32_FLOPS)):
        ms = time_ms(lambda: kernel(precise))
        bound_ms, bound_by = bound(flops, nbytes[route], peak)
        per_launch = launch_ms(lambda: kernel(precise), cuda_launches[route])
        out[route] = {"ms": ms, "plain_ms": time_ms(lambda: plain(precise)),
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "cuda_launches_per_call": cuda_launches[route],
                      "launches_per_s": cuda_launches[route] / ms * 1e3,
                      "host_ms": host_ms(lambda: kernel(precise)),
                      "launch_ms": per_launch, "device_ms": sum(per_launch)}
    out["fast"]["pair_bound_ms"] = bound(issued, nbytes["fast"], PEAK_BF16_FLOPS)[0]
    return out


def temporal_work(b, t, d, o, k, residual):
    """(FLOPs, bytes per route, the fast route's issued FLOPs) of one B1
    call: the products once and the normalisation; x, the weights (bf16 on
    the fast route), the affine and bias read once, the output (and
    residual) written or read once. The fast route issues the products
    twice (both halves of the activation's bf16 pair): a cost of its
    design, not work of the function, so only `pair_bound_ms` counts it."""
    gemm = 2 * b * t * o * k * d
    rest = 10 * b * t * d + b * t * o
    acts = 4 * (b * t * d + 2 * d + o + b * t * o * (2 if residual else 1))
    return (gemm + rest,
            {"fast": acts + 2 * k * d * o, "precise": acts + 4 * k * d * o},
            2 * gemm + rest)


def check_temporal(dev, g):
    from h36x_torch.ops.temporal import (
        bf16_kernel,
        fused_gn_relu_cconv,
        reference_gn_relu_cconv,
    )

    d = o = 1024
    k, groups = 3, 32
    w = uniform((k, d, o), k * d, g, dev)
    wb = bf16_kernel(w)
    cb = uniform((o,), k * d, g, dev)
    scale = (1 + 0.1 * torch.randn(d, generator=g)).to(dev)
    bias = (0.1 * torch.randn(d, generator=g)).to(dev)

    def run(x, res, precise):
        return fused_gn_relu_cconv(x, scale, bias, w, cb, res, groups=groups,
                                   precise=precise, kernel_bf16=None if precise else wb)

    def plain(x, res, precise):
        return reference_gn_relu_cconv(x, scale, bias, w, cb, res, groups=groups,
                                       precise=precise)

    worst = worst_rel = fast_worst = 0.0
    for b, t, with_res in ((16, 40, False), (16, 40, True), (32, 40, True),
                           (16, 1, False), (16, 2, True), (16, 3, False),
                           (1, 40, True)):
        x = (2 * torch.randn(b, t, d, generator=g) + 0.5).to(dev)
        res = torch.randn(b, t, o, generator=g).to(dev) if with_res else None
        got = run(x, res, True)
        want = plain(x, res, True)
        rec = compare(f"temporal B={b} T={t} residual={with_res}", got, want,
                      KERNEL_TOL)
        worst = max(worst, rec["max_abs_err"])
        worst_rel = max(worst_rel, rec["max_rel_err"])
        fast_worst = max(fast_worst, check_fast(
            f"temporal B={b} T={t} residual={with_res}", run(x, res, False),
            run(x, res, False), plain(x, res, False), want))
    # the rollout's shapes: the first T rows of each sample of a (8, 65, D)
    # buffer for every T from 40 to 64, x and the residual strided along the
    # batch, bit for bit the dense call (both routes); the stream's: B 1 at
    # T 20 and 40
    x_buf = (2 * torch.randn(8, 65, d, generator=g) + 0.5).to(dev)
    r_buf = torch.randn(8, 65, o, generator=g).to(dev)
    prefix_worst = prefix_fast = 0.0
    for t in range(40, 65):
        x, res = x_buf[:, :t], r_buf[:, :t]
        for precise in (True, False):
            got = run(x, res, precise)
            dense = run(x.contiguous(), res.contiguous(), precise)
            torch.cuda.synchronize()
            if x.is_contiguous() or not torch.equal(got, dense):
                raise AssertionError(f"temporal prefix T={t} precise={precise}: "
                                     "strided call differs from the dense one")
            if precise:
                want = plain(x, res, True)
                if not torch.allclose(got, want, **KERNEL_TOL):
                    compare(f"temporal prefix B=8 T={t} of 65", got, want, KERNEL_TOL)
                prefix_worst = max(prefix_worst, float((got - want).abs().max()))
            else:
                prefix_fast = max(prefix_fast, check_fast(
                    f"temporal prefix B=8 T={t} of 65", got, run(x, res, False),
                    plain(x, res, False), want, quiet=True))
    log({"check": "temporal prefix B=8 T=40..64 of 65, strided = dense, vs plain",
         "max_abs_err": prefix_worst, "tol": KERNEL_TOL,
         "fast_max_abs_err": prefix_fast, "fast_tol": FAST_TOL,
         "fast_rel_norm_tol": FAST_REL_NORM, "f32_rel_norm_tol": F32_REL_NORM,
         "ok": True})
    worst = max(worst, prefix_worst)
    fast_worst = max(fast_worst, prefix_fast)
    for t in (20, 40):
        x = (2 * torch.randn(1, t, d, generator=g) + 0.5).to(dev)
        want = plain(x, x, True)
        worst = max(worst, compare(f"temporal B=1 T={t} residual=True", run(x, x, True),
                                   want, KERNEL_TOL)["max_abs_err"])
        fast_worst = max(fast_worst, check_fast(
            f"temporal B=1 T={t} residual=True", run(x, x, False), run(x, x, False),
            plain(x, x, False), want))
    # times on both routes: the serving shape, the rollout's strided B 8 at T
    # 52, one exact push's B 1 at T 40
    x16 = (2 * torch.randn(16, 40, d, generator=g) + 0.5).to(dev)
    x52 = x_buf[:, :52]
    x1 = (2 * torch.randn(1, 40, d, generator=g) + 0.5).to(dev)
    timed = {}
    for key, x in (("B16_T40", x16), ("B8_T52_strided", x52), ("B1_T40", x1)):
        b, t, _ = x.shape
        timed[key] = time_routes(lambda precise: run(x, None, precise),
                                 lambda precise: plain(x, None, precise),
                                 temporal_work(b, t, d, o, k, False),
                                 {"fast": 2, "precise": 2})
    log({"check": "temporal timing", "card": torch.cuda.get_device_name(0), **timed})
    # the training shape (batch 32) too, on the route that trains
    x = (2 * torch.randn(32, 40, d, generator=g) + 0.5).to(dev)
    train_ms = time_ms(lambda: run(x, None, True))
    train_plain_ms = time_ms(lambda: plain(x, None, True))
    head = timed["B16_T40"]["fast"]
    return {"name": "gn_relu_cconv", "route": "cuda",
            "ms_train_shape_precise": train_ms,
            "plain_ms_train_shape_precise": train_plain_ms,
            "routes": timed,
            "source": "h36x_torch/ops/csrc/temporal.cu",
            "replaces": "h36x/ops/pallas_temporal.py:42",
            "max_abs_err": max(worst, fast_worst), "max_abs_err_precise": worst,
            "max_abs_err_fast": fast_worst,
            "max_rel_err": worst_rel, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,
            "shape": f"B=16 T=40 D={d} O={o} K={k} G={groups}, fast route",
            "tol": KERNEL_TOL, "fast_tol": FAST_TOL}


def regressor_work(n, d, h, p, iters):
    """(FLOPs, bytes per route, the fast route's issued FLOPs) of one B3
    call: the products once and the elementwise work; phi, the weights
    (bf16 on the fast route) and biases read once, y written once. The fast
    route issues the products twice (both halves of each activation's bf16
    pair), which only `pair_bound_ms` counts."""
    gemm = 2 * n * d * h + iters * (2 * n * p * h + 2 * n * h * h + 2 * n * h * p)
    rest = iters * (4 * n * h + 2 * n * p)
    acts = 4 * (n * d + h + h + p + n * p)
    weights = (d + p) * h + h * h + h * p
    return (gemm + rest,
            {"fast": acts + 2 * weights, "precise": acts + 4 * weights},
            2 * gemm + rest)


def check_regressor(dev, g):
    from h36x_torch.ops.regressor import (
        _reference_forward,
        bf16_weights,
        fused_joint_regressor,
    )

    d = h = 1024
    p, iters = 51, 3
    ws = (uniform((d + p, h), d + p, g, dev), uniform((h,), d + p, g, dev),
          uniform((h, h), h, g, dev), uniform((h,), h, g, dev),
          uniform((h, p), h, g, dev), uniform((p,), h, g, dev))
    wb = bf16_weights(ws[0], ws[2], ws[4])

    def run(phi, precise):
        return fused_joint_regressor(phi, *ws, iters, p, precise=precise,
                                     weights_bf16=None if precise else wb)

    def plain(phi, precise):
        return _reference_forward(phi, *ws, iters, p, precise)

    worst = worst_rel = fast_worst = 0.0
    # 640 and 1280: serving and training; 13: a ragged tile; 1: one streamed
    # frame; 200: the 8 x 25 future strips of a rollout
    phis = {}
    for n in (640, 1280, 13, 1, 200):
        phi = phis[n] = torch.randn(n, d, generator=g).to(dev)
        want = plain(phi, True)
        rec = compare(f"regressor N={n}", run(phi, True), want, KERNEL_TOL)
        worst = max(worst, rec["max_abs_err"])
        worst_rel = max(worst_rel, rec["max_rel_err"])
        fast_worst = max(fast_worst, check_fast(
            f"regressor N={n}", run(phi, False), run(phi, False), plain(phi, False),
            want))
    timed = {}
    for n in (640, 1, 200):
        timed[f"N{n}"] = time_routes(lambda precise: run(phis[n], precise),
                                     lambda precise: plain(phis[n], precise),
                                     regressor_work(n, d, h, p, iters),
                                     {"fast": 2, "precise": 1})
    log({"check": "regressor timing", "card": torch.cuda.get_device_name(0), **timed})
    # the training shape (N = 32 * 40) too, on the route that trains
    train_ms = time_ms(lambda: run(phis[1280], True))
    train_plain_ms = time_ms(lambda: plain(phis[1280], True))
    head = timed["N640"]["fast"]
    return {"name": "joint_regressor", "route": "cuda",
            "ms_train_shape_precise": train_ms,
            "plain_ms_train_shape_precise": train_plain_ms,
            "routes": timed,
            "source": "h36x_torch/ops/csrc/regressor.cu",
            "replaces": "h36x/ops/pallas_regressor.py:39",
            "max_abs_err": max(worst, fast_worst), "max_abs_err_precise": worst,
            "max_abs_err_fast": fast_worst,
            "max_rel_err": worst_rel, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,
            "shape": f"N=640 D={d} H={h} P={p} iters={iters}, fast route",
            "tol": KERNEL_TOL, "fast_tol": FAST_TOL}


def grads(fn, leaves, gout, **kw):
    """Gradients of sum(fn(*leaves) * gout) w.r.t. every leaf (not None)."""
    out = fn(*leaves, **kw)
    return torch.autograd.grad(out, [v for v in leaves if v is not None], gout)


def temporal_bwd_work(b, t, d, o, k, groups):
    """(FLOPs, bytes, the contractions' FLOPs) of the temporal backward: the
    dr and dW contractions and about 20 elementwise operations per input
    element; x, g, W, the affine and the statistics read once, dx, dW,
    dscale, dbias written once."""
    gemm = 2 * (2 * b * t * k * d * o)
    nbytes = 4 * (2 * b * t * d + b * t * o + 2 * k * d * o + 4 * d + 2 * b * groups)
    return gemm + 20 * b * t * d, nbytes, gemm


def hold_grads(name, got, want, tol, rn_tol) -> tuple:
    """Every gradient of `got` within `tol` element-wise and `rn_tol` by
    relative norm of the same one of `want`; a leaf that fails is logged in
    full (compare) and raises, the rest in one record. Returns the largest
    (abs, relative-to-max) error."""
    torch.cuda.synchronize()
    worst = worst_rel = worst_rn = 0.0
    for i, (a, ref) in enumerate(zip(got, want)):
        err = float((a - ref).abs().max())
        rn = rel_norm(a, ref)
        if not (bool(torch.isfinite(a).all()) and torch.allclose(a, ref, **tol)
                and rn <= rn_tol):
            compare(f"{name} leaf {i}", a, ref, tol, rn_tol)
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / max(float(ref.abs().max()), 1e-30))
        worst_rn = max(worst_rn, rn)
    log({"check": name, "leaves": len(got), "max_abs_err": worst, "max_rel_err": worst_rel,
         "rel_norm_err": worst_rn, "tol": tol, "rel_norm_tol": rn_tol})
    return worst, worst_rel


def hold_routes(name, on_route, routes, want, split_plain, tol) -> dict:
    """Each backward route (on_route(route), uncounted) twice: the two runs
    equal bit for bit, each within `tol` and REL_NORM_TOL of float32
    autograd (`want`), the hopper route also of its split plain version.
    Returns each route's largest abs error against autograd."""
    out = {}
    for route in routes:
        got, again = on_route(route), on_route(route)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} {route}: two runs differ")
        out[route] = hold_grads(f"{name} {route} vs float32 autograd (runs equal)", got,
                                want, tol, REL_NORM_TOL)[0]
        if route == "hopper":
            hold_grads(f"{name} hopper vs its split plain version", got, split_plain, tol,
                       REL_NORM_TOL)
    return out


def check_temporal_bwd(dev, g):
    from h36x_torch.ops.temporal import (
        BWD_ROUTES,
        _launch_forward,
        bwd_on_route,
        fused_gn_relu_cconv,
        gn_relu_cconv_bwd,
        reference_gn_relu_cconv,
        reference_gn_relu_cconv_bwd_split,
        temporal_bwd_route,
    )

    d = o = 1024
    k, groups = 3, 32
    w = uniform((k, d, o), k * d, g, dev)
    cb = uniform((o,), k * d, g, dev)
    scale = (1 + 0.1 * torch.randn(d, generator=g)).to(dev)
    bias = (0.1 * torch.randn(d, generator=g)).to(dev)
    route = temporal_bwd_route(d, o)
    worst = worst_rel = 0.0
    by_route = dict.fromkeys(BWD_ROUTES, 0.0)
    for b, t, with_res in ((32, 40, False), (32, 40, True), (32, 1, True),
                           (32, 2, False), (32, 3, True), (32, 4, False),
                           (1, 40, True), (1, 2, False)):
        name = f"temporal bwd B={b} T={t} residual={with_res}"
        x = (2 * torch.randn(b, t, d, generator=g) + 0.5).to(dev)
        res = torch.randn(b, t, o, generator=g).to(dev) if with_res else None
        gout = torch.randn(b, t, o, generator=g).to(dev)
        leaves = [None if v is None else v.clone().requires_grad_()
                  for v in (x, scale, bias, w, cb, res)]
        before = gn_relu_cconv_bwd.launches_by_route[route]
        got = grads(fused_gn_relu_cconv, leaves, gout, groups=groups, precise=True)
        if gn_relu_cconv_bwd.launches_by_route[route] != before + 1:
            raise AssertionError(f"{name}: the backward did not run on the {route} route")
        want = grads(reference_gn_relu_cconv, leaves, gout, groups=groups)
        err, err_rel = hold_grads(f"{name} ({route}) vs float32 autograd", got, want,
                                  GRAD_TOL, REL_NORM_TOL)
        worst, worst_rel = max(worst, err), max(worst_rel, err_rel)
        # each route on the forward's statistics: dx, dW, dscale, dbias
        _, mean, rstd = _launch_forward(x, scale, bias, w, cb, None, groups, 1e-5, True, None)
        split = reference_gn_relu_cconv_bwd_split(x, scale, bias, w, gout, groups,
                                                  mean=mean, rstd=rstd)
        errs = hold_routes(name, lambda r: bwd_on_route(x, scale, bias, w, gout, mean, rstd,
                                                        groups, r),
                           BWD_ROUTES, (want[0], want[3], want[1], want[2]), split, GRAD_TOL)
        by_route = {r: max(by_route[r], errs[r]) for r in BWD_ROUTES}
    b, t = 32, 40
    x = (2 * torch.randn(b, t, d, generator=g) + 0.5).to(dev)
    gout = torch.randn(b, t, o, generator=g).to(dev)
    _, mean, rstd = _launch_forward(x, scale, bias, w, cb, None, groups, 1e-5, True, None)
    ms = time_ms(lambda: gn_relu_cconv_bwd(x, scale, bias, w, gout, mean, rstd, groups))
    general_ms = time_ms(lambda: bwd_on_route(x, scale, bias, w, gout, mean, rstd, groups,
                                              "general"))
    per_launch = launch_ms(lambda: bwd_on_route(x, scale, bias, w, gout, mean, rstd, groups,
                                                "hopper"), 5)
    leaves = [v.clone().requires_grad_() for v in (x, scale, bias, w, cb)]
    out = reference_gn_relu_cconv(*leaves, groups=groups)
    plain_ms = time_ms(lambda: torch.autograd.grad(out, leaves, gout,
                                                   retain_graph=True))
    flops, nbytes, gemm = temporal_bwd_work(b, t, d, o, k, groups)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    pass_bound_ms = bound(flops + (SPLIT_PASSES - 1) * gemm, nbytes, PEAK_BF16_FLOPS)[0]
    general_bound_ms = bound(flops, nbytes)[0]
    routes = {"hopper": {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "pass_bound_ms": pass_bound_ms, "passes": SPLIT_PASSES,
                         "launch_ms": per_launch, "device_ms": sum(per_launch),
                         "max_abs_err": by_route["hopper"]},
              "general": {"ms": general_ms, "bound_ms": general_bound_ms,
                          "max_abs_err": by_route["general"]}}
    log({"check": "temporal bwd timing", "card": torch.cuda.get_device_name(0), **routes})
    return {"name": "gn_relu_cconv_bwd", "route": "cuda", "kernel_route": route,
            "source": "h36x_torch/ops/csrc/temporal_bwd.cu",
            "replaces": "h36x/ops/pallas_temporal.py:175",
            "max_abs_err": worst, "max_rel_err": worst_rel, "ms": ms,
            "general_ms": general_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "pass_bound_ms": pass_bound_ms, "library_ms": None,
            "routes": routes,
            "shape": f"B={b} T={t} D={d} O={o} K={k} G={groups}, {route} route",
            "tol": GRAD_TOL, "rel_norm_tol": REL_NORM_TOL}


def regressor_bwd_work(n, d, h, p, iters):
    """(FLOPs, bytes, the products' FLOPs) of the regressor backward as the
    kernel does it: the forward recomputed, then the unrolled loop's
    backward (the products and about 4 elementwise operations per hidden
    unit and round); phi, g and the weights read once, dphi and the weight
    grads written once."""
    fwd = 2 * n * d * h + iters * (2 * n * p * h + 2 * n * h * h + 2 * n * h * p)
    bwd = (iters * (2 * n * p * h + 2 * n * h * h + 2 * n * h * p  # dh2, dh1, dy
                    + 2 * n * h * p + 2 * n * h * h + 2 * n * p * h)  # dW3, dW2, dW1y
           - 2 * n * h * p  # no dy below round 0
           + 2 * (2 * n * d * h))  # dphi, dW1p
    weights = (d + p) * h + h + h * h + h + h * p + p
    gemm = fwd + bwd
    return gemm + 4 * iters * n * h, 4 * (2 * n * d + n * p + 2 * weights), gemm


def away_from_zero(shape, g, lo=0.6, hi=1.5):
    """Values of random sign with lo <= |v| <= hi."""
    mag = lo + (hi - lo) * torch.rand(shape, generator=g)
    return torch.where(torch.rand(shape, generator=g) < 0.5, -mag, mag)


def tie_free_regressor(d, h, p, g, dev):
    """Regressor weights whose ReLU inputs stay at least ~0.2 away from 0:
    weights at a tenth of their init scale, hidden biases of random sign
    and magnitude 0.6-1.5. A gradient through a ReLU changes by a whole term
    where its input is so close to 0 that two FP32 summation orders give it
    different signs; at N = 1280 and H = 1024 the init-scale weights put
    about ten of the 8 M ReLU inputs that close, so an element-wise
    comparison of two correct implementations fails there. Away from 0 both
    sides take the same mask and the tolerance holds; the mask is still
    applied per element (about half the units are off)."""
    return (0.1 * uniform((d + p, h), d + p, g, dev), away_from_zero((h,), g).to(dev),
            0.1 * uniform((h, h), h, g, dev), away_from_zero((h,), g).to(dev),
            uniform((h, p), h, g, dev), uniform((p,), h, g, dev))


def relu_inputs(phi, ws, iters, p):
    """Every ReLU input of the regressor loop in float64, round by round,
    as a list of (N, H) tensors: [h1 round 0, h2 round 0, h1 round 1, ...]."""
    w1, b1, w2, b2, w3, b3 = (w.double() for w in ws)
    phi = phi.double()
    y = phi.new_zeros(phi.shape[0], p)
    pre = []
    for _ in range(iters):
        a1 = torch.cat([phi, y], -1) @ w1 + b1
        a2 = torch.relu(a1) @ w2 + b2
        y = y + torch.relu(a2) @ w3 + b3
        pre += [a1, a2]
    return pre


def untied_rows(n, d, ws, iters, p, g, dev, margin=1e-5):
    """(n, d) normal rows of phi none of whose ReLU inputs in the regressor
    loop lies within `margin` of 0 (float64): a row with such a near-tie is
    drawn again. Each row is its own forward, so this changes no other row.
    The margin is about 100x the FP32 rounding of a pre-activation at these
    widths, so an FP32 kernel and FP32 autograd take the same mask; the
    masks still differ from row to row and round to round, as at init."""
    phi = torch.randn(n, d, generator=g).to(dev)
    redrawn = 0
    for _ in range(50):
        tied = torch.stack([(a.abs() < margin).any(1)
                            for a in relu_inputs(phi, ws, iters, p)]).any(0)
        if not tied.any():
            return phi, redrawn
        redrawn += int(tied.sum())
        phi[tied] = torch.randn(int(tied.sum()), d, generator=g).to(dev)
    raise AssertionError("could not draw rows clear of ReLU ties")


def mask_variety(phi, ws, iters, p) -> dict:
    """How far the ReLU masks vary: the mean share of rows on which a unit's
    mask differs from that unit's majority (0 when every column has one
    mask), and the share of (row, unit) whose h1/h2 mask differs between
    round 0 and round 1."""
    masks = [a > 0 for a in relu_inputs(phi, ws, iters, p)]
    on = torch.stack([m.double().mean(0) for m in masks])
    out = {"minority_share": float(torch.minimum(on, 1 - on).mean())}
    if iters > 1:
        out["h1_round_change"] = float((masks[0] != masks[2]).double().mean())
        out["h2_round_change"] = float((masks[1] != masks[3]).double().mean())
    return out


def check_regressor_bwd(dev, g):
    from h36x_torch.ops.regressor import (
        BWD_ROUTES,
        _reference_forward,
        bwd_on_route,
        fused_joint_regressor,
        joint_regressor_bwd,
        reference_joint_regressor_bwd_split,
        regressor_bwd_route,
    )

    d = h = 1024
    p, iters = 51, 3
    route = regressor_bwd_route(d, h, p)
    worst = worst_rel = 0.0
    by_route = dict.fromkeys(BWD_ROUTES, 0.0)
    # tie-free weights (every mask fixed per column), then init-scale weights
    # (masks vary by row and round) on rows drawn clear of ReLU ties
    init = (uniform((d + p, h), d + p, g, dev), uniform((h,), d + p, g, dev),
            uniform((h, h), h, g, dev), uniform((h,), h, g, dev),
            uniform((h, p), h, g, dev), uniform((p,), h, g, dev))
    for label, ws in (("tie-free", tie_free_regressor(d, h, p, g, dev)),
                      ("init-scale", init)):
        for n in (1280, 13):
            name = f"regressor bwd {label} N={n}"
            phi, redrawn = untied_rows(n, d, ws, iters, p, g, dev)
            log({"check": f"{name} masks", "rows_redrawn": redrawn,
                 **mask_variety(phi, ws, iters, p)})
            gout = torch.randn(n, p, generator=g).to(dev)
            leaves = [v.clone().requires_grad_() for v in (phi, *ws)]
            before = joint_regressor_bwd.launches_by_route[route]
            got = grads(fused_joint_regressor, leaves, gout, iters=iters, out_dim=p,
                        precise=True)
            if joint_regressor_bwd.launches_by_route[route] != before + 1:
                raise AssertionError(f"{name}: the backward did not run on the {route} route")
            want = grads(_reference_forward, leaves, gout, iters=iters, out_dim=p)
            err, err_rel = hold_grads(f"{name} ({route}) vs float32 autograd", got, want,
                                      KERNEL_TOL, REL_NORM_TOL)
            worst, worst_rel = max(worst, err), max(worst_rel, err_rel)
            split = reference_joint_regressor_bwd_split(phi, *ws, gout, iters)
            errs = hold_routes(name, lambda r: bwd_on_route(phi, *ws, gout, iters, r),
                               BWD_ROUTES, want, split, KERNEL_TOL)
            by_route = {r: max(by_route[r], errs[r]) for r in BWD_ROUTES}
    ws = init
    n = 1280
    phi = torch.randn(n, d, generator=g).to(dev)
    gout = torch.randn(n, p, generator=g).to(dev)
    ms = time_ms(lambda: joint_regressor_bwd(phi, *ws, gout, iters))
    general_ms = time_ms(lambda: bwd_on_route(phi, *ws, gout, iters, "general"))
    # prologue, 3 iters - 1 forward and 3 iters - 1 backward GEMMs (the
    # iters - 1 y and dY phases each split, with a launch that sums them),
    # dphi, 4 weight-gradient GEMMs and their sums, 3 two-pass column sums
    launches = 1 + 2 * (3 * iters - 1) + 2 * (iters - 1) + 1 + 8 + 6
    per_launch = launch_ms(lambda: bwd_on_route(phi, *ws, gout, iters, "hopper"), launches)
    leaves = [v.clone().requires_grad_() for v in (phi, *ws)]
    out = _reference_forward(*leaves, iters, p)
    plain_ms = time_ms(lambda: torch.autograd.grad(out, leaves, gout,
                                                   retain_graph=True))
    flops, nbytes, gemm = regressor_bwd_work(n, d, h, p, iters)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    pass_bound_ms = bound(flops + (SPLIT_PASSES - 1) * gemm, nbytes, PEAK_BF16_FLOPS)[0]
    general_bound_ms = bound(flops, nbytes)[0]
    routes = {"hopper": {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "pass_bound_ms": pass_bound_ms, "passes": SPLIT_PASSES,
                         "launch_ms": per_launch, "device_ms": sum(per_launch),
                         "max_abs_err": by_route["hopper"]},
              "general": {"ms": general_ms, "bound_ms": general_bound_ms,
                          "max_abs_err": by_route["general"]}}
    log({"check": "regressor bwd timing", "card": torch.cuda.get_device_name(0), **routes})
    return {"name": "joint_regressor_bwd", "route": "cuda", "kernel_route": route,
            "source": "h36x_torch/ops/csrc/regressor_bwd.cu",
            "replaces": "h36x/ops/pallas_regressor.py:129",
            "max_abs_err": worst, "max_rel_err": worst_rel, "ms": ms,
            "general_ms": general_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "pass_bound_ms": pass_bound_ms, "library_ms": None,
            "routes": routes,
            "shape": f"N={n} D={d} H={h} P={p} iters={iters}, {route} route",
            "tol": KERNEL_TOL, "rel_norm_tol": REL_NORM_TOL}


async def drive_daemon(server, feats_conc, feats_seq, sock_dir, rounds: int = 1):
    """len(feats_conc) concurrent requests (`rounds` bursts of them), then
    feats_seq one by one, then a stats query: (the first burst's replies +
    the sequential ones, stats)."""
    from h36x_torch.serve_daemon import request_async, stats_async

    path = os.path.join(sock_dir, "serve.sock")
    if len(path.encode()) < 100:  # AF_UNIX path limit
        srv = await server.start(unix_path=path)
        bind = {"unix_path": path}
    else:
        srv = await server.start(host="127.0.0.1", port=0)
        bind = {"host": "127.0.0.1", "port": srv.sockets[0].getsockname()[1]}
    try:
        conc = await asyncio.gather(*[request_async(f, timeout_s=120, **bind)
                                      for f in feats_conc])
        for _ in range(rounds - 1):
            await asyncio.gather(*[request_async(f, timeout_s=120, **bind)
                                   for f in feats_conc])
        seq = [await request_async(f, timeout_s=120, **bind) for f in feats_seq]
        stats = await stats_async(timeout_s=30, **bind)
    finally:
        server.stop()
        srv.close()
        for w in list(server._writers):
            w.close()
        await srv.wait_closed()
    return conc + seq, stats


def path_rel_norms(name, got, plain_same_mode, plain_f32) -> dict:
    """A path in fast mode: within PATH_REL_NORM of the same call with the
    plain engines in the same mode and within PATH_F32_REL_NORM of the
    float32 plain path, by relative norm; both readings logged."""
    rec = {"check": f"{name} fast vs plain", "rel_norm_err": rel_norm(got, plain_same_mode),
           "rel_norm_tol": PATH_REL_NORM, "rel_norm_err_vs_f32": rel_norm(got, plain_f32),
           "f32_rel_norm_tol": PATH_F32_REL_NORM,
           "finite": bool(torch.isfinite(got).all())}
    log(rec)
    if not (rec["finite"] and rec["rel_norm_err"] <= PATH_REL_NORM
            and rec["rel_norm_err_vs_f32"] <= PATH_F32_REL_NORM):
        raise AssertionError(f"{name}: the fast path disagrees with the plain engines")
    return rec


def drive_main_path(dev, g, sock_dir):
    """The daemon, served twice from one checkpoint: precise (its replies
    held to the float32 plain forward at E2E_TOL, the check of the FP32
    port) and at its default, fast (by relative norm against the fast plain
    forward and the float32 one); each run with the counts set to 0 just
    before it and read just after. Then phd_forward_fused with f_AR and the
    second regressor pass, both modes."""
    from h36x_torch.config import SEQ_LEN, ModelConfig
    from h36x_torch.infer import make_fused_forward, phd_forward_fused, serving_params
    from h36x_torch.models.phd import PHDFor3DJoints, param_tree
    from h36x_torch.ops.regressor import fused_joint_regressor
    from h36x_torch.ops.temporal import fused_gn_relu_cconv
    from h36x_torch.serve_daemon import BatchingServer, build_predict_fn
    from h36x_torch.train.checkpoint import save_params

    mc = ModelConfig()
    model = PHDFor3DJoints(generator=torch.Generator().manual_seed(0), device="cpu")
    path = save_params(sock_dir, "best", model.state_dict(),
                       config={"model": dataclasses.asdict(mc),
                               "data": {"seq_len": SEQ_LEN}})
    feats = torch.randn(19, SEQ_LEN, mc.feature_dim, generator=g).numpy()
    params = param_tree(PHDFor3DJoints(generator=torch.Generator().manual_seed(0),
                                       device=dev))
    total = dict.fromkeys(counted(), 0)
    for precise in (True, False):
        mode = "precise" if precise else "fast"
        t0 = time.perf_counter()
        predict_fn, _ = build_predict_fn(model_path=str(path), max_batch=16, warm=True,
                                         precise=precise)
        log({"phase": f"daemon_ready {mode}", "seconds": time.perf_counter() - t0,
             "checkpoint_bytes": os.path.getsize(path)})
        server = BatchingServer(predict_fn, seq_len=SEQ_LEN,
                                feature_dim=mc.feature_dim, max_batch=16,
                                max_wait_ms=5.0)
        zero_counts()
        replies, stats = asyncio.run(drive_daemon(server, list(feats[:16]),
                                                  list(feats[16:]), sock_dir))
        launches = read_counts()

        batches = stats["batches"]
        log({"phase": f"daemon {mode}", "requests": stats["requests"], "batches": batches,
             "rows": stats["rows"], "launches": launches,
             "request_ms_p50": stats["request_ms"]["p50"],
             "request_ms_p99": stats["request_ms"]["p99"],
             "device_ms_p50": stats["batch_device_ms"]["p50"],
             "device_ms_p99": stats["batch_device_ms"]["p99"]})
        if stats["requests"] != 19 or stats["rows"] != 19:
            raise AssertionError(f"daemon served {stats['requests']} requests, "
                                 f"{stats['rows']} rows; sent 19")
        want_launches = expect_counts(gn_relu_cconv=2 * mc.num_blocks * batches,
                                      joint_regressor=batches)
        if launches != want_launches:
            raise AssertionError(f"launch counts {launches} != {want_launches} "
                                 f"for {batches} device batches")
        for k, v in launches.items():
            total[k] += v

        f32 = make_fused_forward(params, use_kernels=False, precise=True)
        same = make_fused_forward(params, use_kernels=False, precise=precise)
        got = torch.from_numpy(np.stack([np.array(r) for r in replies])).to(dev)
        want = torch.cat([f32(torch.from_numpy(feats[i:i + 1]).to(dev))
                          for i in range(len(replies))])
        if got.shape != want.shape:
            raise AssertionError(f"daemon replies: shape {tuple(got.shape)}")
        if precise:
            for i in range(len(replies)):
                if not (torch.isfinite(got[i]).all()
                        and torch.allclose(got[i], want[i], **E2E_TOL)):
                    compare(f"daemon reply {i}", got[i], want[i], E2E_TOL)
            log({"check": "daemon replies vs plain forward", "replies": len(replies),
                 "tol": E2E_TOL, "ok": True})
        else:
            plain = torch.cat([same(torch.from_numpy(feats[i:i + 1]).to(dev))
                               for i in range(len(replies))])
            path_rel_norms("daemon replies", got, plain, want)

    # phd_forward_fused with f_AR and the second regressor pass, over the
    # tree an engine serves from (the fast mode's weight copies made once)
    x = torch.from_numpy(feats[:16]).to(dev)
    names = ("phi", "phi_hat", "joints_phi", "joints_hat")
    with torch.inference_mode():
        f32 = phd_forward_fused(params, x, predict_future=True, use_kernels=False,
                                precise=True)
    for precise in (True, False):
        before = (fused_gn_relu_cconv.launches, fused_joint_regressor.launches)
        with torch.inference_mode():
            got = phd_forward_fused(serving_params(params, precise=precise), x,
                                    predict_future=True, precise=precise)
            plain = phd_forward_fused(params, x, predict_future=True, use_kernels=False,
                                      precise=precise)
        for name, a, b, c in zip(names, got, plain, f32):
            if precise:
                compare(f"phd_forward_fused {name}", a, b, E2E_TOL)
            else:
                path_rel_norms(f"phd_forward_fused {name}", a, b, c)
        grown = (fused_gn_relu_cconv.launches - before[0],
                 fused_joint_regressor.launches - before[1])
        if grown != (2 * (mc.num_blocks + mc.ar_num_blocks), 2):
            raise AssertionError(f"phd_forward_fused launched {grown}")
    return total


def counted() -> dict:
    """Kernel name -> the wrapper that counts its launches."""
    from h36x_torch.ops import bottleneck, matmul_probe, regressor, temporal

    return {"gn_relu_cconv": temporal.fused_gn_relu_cconv,
            "gn_relu_cconv_bwd": temporal.gn_relu_cconv_bwd,
            "joint_regressor": regressor.fused_joint_regressor,
            "joint_regressor_bwd": regressor.joint_regressor_bwd,
            "fused_bottleneck": bottleneck.fused_bottleneck,
            "matmul_probe": matmul_probe.probe_matmul}


def zero_counts():
    for fn in counted().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counted().items()}


def backward_routes() -> dict:
    """The backward kernels' launches by route."""
    from h36x_torch.ops import regressor, temporal

    return {"gn_relu_cconv_bwd": dict(temporal.gn_relu_cconv_bwd.launches_by_route),
            "joint_regressor_bwd": dict(regressor.joint_regressor_bwd.launches_by_route)}


def expect_counts(**launched) -> dict:
    """The full count dict with `launched` set and every other kernel at 0."""
    return {**dict.fromkeys(counted(), 0), **launched}


def make_tie_free_(model, g) -> None:
    """Move every ReLU input of the phase-1 path away from 0 (see
    tie_free_regressor): GroupNorm scale 0.1 and biases of random sign and
    magnitude 0.6-1.5, regressor as tie_free_regressor."""
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if ".gn" in name and name.endswith(".scale"):
                prm.fill_(0.1)
            elif ".gn" in name and name.endswith(".bias"):
                prm.copy_(away_from_zero(prm.shape, g))
            elif name in ("f_3D.fc1.kernel", "f_3D.fc2.kernel"):
                prm.mul_(0.1)
            elif name in ("f_3D.fc1.bias", "f_3D.fc2.bias"):
                prm.copy_(away_from_zero(prm.shape, g))


def check_train_step(dev, g):
    """One full-width phase-1 step, fused against plain, on one batch from
    the same generator, at dropout 0 (all four kernels) and 0.5 (the same
    masks on both sides, regressor plain): the loss within LOSS_TOL; at the
    seeded init every gradient leaf by relative norm within SEEDED_REL_NORM_TOL
    (ReLU masks vary by row there, and a few of the 13 M ReLU inputs lie so
    close to 0 that the two FP32 orders flip them); on tie-free parameters
    every gradient leaf within GRAD_TOL and by relative norm within
    REL_NORM_TOL. max|grad| of every leaf is logged. Also the step's time
    both ways."""
    from h36x_torch.config import SEQ_LEN, ModelConfig
    from h36x_torch.models.phd import PHDFor3DJoints
    from h36x_torch.train.state import make_optimizer
    from h36x_torch.train.step import grads_and_metrics

    mc = ModelConfig()
    b = 32
    model = PHDFor3DJoints(generator=torch.Generator().manual_seed(1), device=dev)
    make_optimizer(model, 1e-4)  # phase 1: f_AR frozen
    trainable = [(n, prm) for n, prm in model.named_parameters() if prm.requires_grad]
    feats = torch.randn(b, SEQ_LEN, mc.feature_dim, generator=g).to(dev)
    batch = (feats, (0.3 * torch.randn(b, SEQ_LEN, 17, 3, generator=g)).to(dev),
             (100 * torch.randn(b, SEQ_LEN, 17, 2, generator=g)).to(dev),
             (1000 * torch.eye(3)).expand(b, 3, 3).contiguous().to(dev))

    def both(dropout):
        model.dropout = dropout
        out = {}
        for fused in (True, False):
            zero_counts()
            gen = torch.Generator(device=dev).manual_seed(7)
            m = grads_and_metrics(model, batch, gen, fused=fused)
            torch.cuda.synchronize()
            out[fused] = (m, {n: prm.grad.clone() for n, prm in trainable},
                          read_counts(), backward_routes())
        return out

    rec = {"phase": "train_step", "batch": b, "trainable_tensors": len(trainable)}
    for params in ("seeded", "tie-free"):
        if params == "tie-free":
            make_tie_free_(model, g)
        for dropout in (0.0, 0.5):
            out = both(dropout)
            (m_f, g_f, n_f, r_f), (m_p, g_p, n_p, _) = out[True], out[False]
            compare(f"step loss {params} dropout={dropout}", m_f["loss"], m_p["loss"],
                    LOSS_TOL)
            # element-wise only where no ReLU input lies near 0
            tol, rn_tol = ((None, SEEDED_REL_NORM_TOL) if params == "seeded"
                           else (GRAD_TOL, REL_NORM_TOL))
            leaves = {}
            for name, _ in trainable:
                got, want = g_f[name], g_p[name]
                leaves[name] = {"rel_norm_err": rel_norm(got, want),
                                "max_abs_err": float((got - want).abs().max()),
                                "max_abs_grad": float(want.abs().max())}
                if not (leaves[name]["rel_norm_err"] <= rn_tol
                        and (tol is None or torch.allclose(got, want, **tol))):
                    compare(f"step grad {params} dropout={dropout} {name}", got, want,
                            tol, rn_tol)
            want = expect_counts(gn_relu_cconv=4, gn_relu_cconv_bwd=4,
                                 joint_regressor=1 if dropout == 0.0 else 0,
                                 joint_regressor_bwd=1 if dropout == 0.0 else 0)
            if n_f != want or any(n_p.values()):
                raise AssertionError(f"step launches fused {n_f} (want {want}), "
                                     f"plain {n_p} (want none)")
            if (r_f["gn_relu_cconv_bwd"] != {"general": 0, "hopper": 4}
                    or r_f["joint_regressor_bwd"]["hopper"] != want["joint_regressor_bwd"]
                    or r_f["joint_regressor_bwd"]["general"]):
                raise AssertionError(f"step backward routes {r_f}: want every B2 and B4 "
                                     "on the hopper route")
            log({"check": f"step grads {params} dropout={dropout}", "leaves": leaves})
            rec[f"{params}_dropout_{dropout}"] = {
                "loss": float(m_f["loss"]), "launches": n_f, "backward_routes": r_f,
                "grad_max_abs_err": max(v["max_abs_err"] for v in leaves.values()),
                "grad_max_rel_norm_err": max(v["rel_norm_err"] for v in leaves.values()),
                "grad_min_max_abs": min(v["max_abs_grad"] for v in leaves.values())}
    model.dropout = 0.0
    gen = torch.Generator(device=dev)
    for fused in (True, False):
        rec[f"step_ms_{'fused' if fused else 'plain'}"] = time_ms(
            lambda: grads_and_metrics(model, batch, gen, fused=fused), reps=10)
    rec["tol"] = {"loss": LOSS_TOL, "grad": GRAD_TOL, "rel_norm": REL_NORM_TOL,
                  "seeded_rel_norm": SEEDED_REL_NORM_TOL}
    log(rec)
    return rec


def write_store(root, g, clips=128, per_shard=16, t=40, f=2048, train_clips=None):
    """A full-width feature store: `clips` clips of (t, f) features, one
    variant each, the first `train_clips` (half when None) subject 1
    (train), the rest subject 5 (val), written with the port's
    ShardWriter."""
    from h36x_torch.data.shards import ShardWriter, write_index

    train_clips = clips // 2 if train_clips is None else train_clips
    writer = ShardWriter(root, n_vars=1)
    index = []
    for sid in range(clips // per_shard):
        subject = 1 if sid < train_clips // per_shard else 5
        arrays = {
            "feats": torch.randn(per_shard, t, f, generator=g).numpy(),
            "joints3d": (300 * torch.randn(per_shard, t, 17, 3, generator=g)).numpy(),
            "joints2d": (100 * torch.randn(per_shard, t, 17, 2, generator=g)).numpy(),
            "K": (1000 * torch.eye(3)).expand(per_shard, 3, 3).contiguous().numpy(),
        }
        meta = [{"subject": subject, "action": f"A{c}", "cam": "cam_0",
                 "start": 10 * c} for c in range(per_shard)]
        writer.write(arrays, meta)
        index += [{"shard_id": sid, "row": c, "subject": subject,
                   "action": f"A{c}", "cam": "cam_0", "start": 10 * c}
                  for c in range(per_shard)]
    write_index(root, index, n_shards=clips // per_shard, n_clips=clips,
                n_variants=1, aug_names=["orig"], seq_len=t, frame_skip=2,
                feat_dtype="float32")


TRAIN = dict(epochs=2, batch=32, train_clips=128, val_clips=64)  # the trainer's runs


def train_argv(store, outdir, *flags):
    """cli.train's arguments for the trainer's runs on `store`: fused
    kernels, dropout 0, TRAIN's epochs and batch, then `flags`."""
    return ["--train-root", store, "--train-subjects", "1", "--val-subjects", "5",
            "--outdir", outdir, "--optim.fused", "true", "--model.dropout", "0",
            "--optim.epochs", str(TRAIN["epochs"]), "--optim.batch-size",
            str(TRAIN["batch"]), "--optim.log-every", "0", *flags]


def read_rows(outdir) -> list:
    with open(os.path.join(outdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def drive_train_path(g, tmp):
    """The trainer end to end: h36x_torch.cli.train.main over a full-width
    store, 2 epochs, fused kernels, dropout 0; returns the launch counts."""
    import math

    from h36x_torch.cli.train import main as train_main
    from h36x_torch.train.checkpoint import load_params_only

    store, outdir = os.path.join(tmp, "store"), os.path.join(tmp, "runs")
    t0 = time.perf_counter()
    write_store(store, g, clips=TRAIN["train_clips"] + TRAIN["val_clips"],
                train_clips=TRAIN["train_clips"])
    log({"phase": "store_written", "seconds": time.perf_counter() - t0})
    epochs, batch, train_clips, val_clips = (TRAIN[k] for k in (
        "epochs", "batch", "train_clips", "val_clips"))
    zero_counts()
    t0 = time.perf_counter()
    model, best = train_main(train_argv(store, outdir))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()

    steps = epochs * (train_clips // batch)
    evals = epochs * math.ceil(val_clips / batch)
    want = expect_counts(gn_relu_cconv=4 * steps + 4 * evals,
                         gn_relu_cconv_bwd=4 * steps,
                         joint_regressor=steps + evals, joint_regressor_bwd=steps)
    rows = read_rows(outdir)
    log({"phase": "trainer", "seconds": seconds, "train_steps": steps,
         "eval_batches": evals, "launches": launches, "best_val_mpjpe": best,
         "metrics": rows})
    if launches != want:
        raise AssertionError(f"trainer launches {launches} != {want}")
    if len(rows) != epochs or not all(
            math.isfinite(r[k]) for r in rows for k in ("train_loss", "val_loss",
                                                        "val_mpjpe")):
        raise AssertionError(f"metrics.jsonl: {rows}")
    for name in ("best.msgpack", "best.json", "last.msgpack", "last.json"):
        if not os.path.exists(os.path.join(outdir, name)):
            raise AssertionError(f"trainer wrote no {name}")
    saved = {k: v.cpu() for k, v in model.state_dict().items()}
    last = load_params_only(os.path.join(outdir, "last.msgpack"), saved)
    if not all(torch.equal(last[k], saved[k]) for k in saved):
        raise AssertionError("last.msgpack differs from the trained model")
    with open(os.path.join(outdir, "best.json")) as f:
        best_epoch = json.load(f)["epoch"]
    best_params = load_params_only(os.path.join(outdir, "best.msgpack"), saved)
    if best_epoch == epochs - 1 and not all(
            torch.equal(best_params[k], saved[k]) for k in saved):
        raise AssertionError("best.msgpack (last epoch) differs from the model")
    log({"check": "trainer checkpoints", "best_epoch": best_epoch, "ok": True})
    return launches


ROW_KEYS = ("lr", "train_loss", "train_mpjpe", "val_loss", "val_mpjpe", "val_bone")


def ours(name: str) -> bool:
    """A CUDA kernel of h36x_torch/ops/csrc (anonymous namespaces and
    hopper.cuh's h36x_hopper), not PyTorch's or cuBLAS's."""
    return (("(anonymous namespace)::" in name or "h36x_hopper::" in name)
            and "at::" not in name and "c10::" not in name)


def traced_kernels(fn) -> dict:
    """Name -> count of this package's CUDA kernels in a torch.profiler
    trace of fn (CUPTI's kernel records, replayed graph nodes included)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return dict(Counter(e.name for e in prof.events()
                        if e.device_type == DeviceType.CUDA and ours(e.name)))


def check_graphed_train_step(dev, g, smi):
    """The grouped train step at full width (flagship model, batch 32 x T
    40, fused, k = 4 steps a group): the first group runs eagerly and
    captures one CUDA graph of the 4 steps; then

    - graph against eager: one replay against the same 4 steps run
      eagerly from the same params and AdamW state: params, mu, nu, count
      and metrics bit for bit; the wrappers count no launch during the
      replay, and a torch.profiler trace of the replay holds the same
      kernels of B1-B4 as the eager group's (4 x (4 B1 + 4 B2 + 1 B3 +
      1 B4) calls);
    - the learning rate reaches the graph: set_learning_rate between two
      replays, the second equal to eager steps at the new rate;
    - dropout under the graph: at dropout 0.5 the generator is registered,
      two replays of one batch from one state draw other masks (other
      losses), as two eager groups do;
    - ms per step, eager and graphed (CUDA events)."""
    from h36x_torch.config import SEQ_LEN, ModelConfig
    from h36x_torch.models.phd import PHDFor3DJoints
    from h36x_torch.train.state import make_optimizer, optimizer_tensors, set_learning_rate
    from h36x_torch.train.step import make_train_step

    mc, b, k = ModelConfig(), 32, 4
    t0 = time.perf_counter()
    model = PHDFor3DJoints(generator=torch.Generator().manual_seed(2), device=dev,
                           dropout=0.0)
    opt, _ = make_optimizer(model, 1e-4)
    state = [*model.parameters(), *optimizer_tensors(opt)]

    def snapshot():
        return [x.detach().clone() for x in state]

    def restore(snap):
        with torch.no_grad():
            for x, y in zip(state, snap):
                x.copy_(y)

    def same(snap) -> bool:
        return all(torch.equal(x, y) for x, y in zip(state, snap))

    def group():
        return ((torch.randn(k, b, SEQ_LEN, mc.feature_dim, generator=g)).to(dev),
                (0.3 * torch.randn(k, b, SEQ_LEN, 17, 3, generator=g)).to(dev),
                (100 * torch.randn(k, b, SEQ_LEN, 17, 2, generator=g)).to(dev),
                (1000 * torch.eye(3)).expand(k, b, 3, 3).contiguous().to(dev))

    groups = [group() for _ in range(3)]
    step = make_train_step(model, opt, fused=True, scan_steps=k)
    t1 = time.perf_counter()
    step(groups[0])
    torch.cuda.synchronize()
    rec = {"phase": "graphed_train_step", "batch": b, "steps_per_graph": k,
           "first_group_and_capture_s": time.perf_counter() - t1}
    if (step.eager_steps, step.graph_replays) != (k, 0):
        raise AssertionError(f"first group: {step.eager_steps} eager, "
                             f"{step.graph_replays} replays")

    # graph against eager, bit for bit
    s0 = snapshot()
    zero_counts()
    replayed = step(groups[1])
    torch.cuda.synchronize()
    if step.graph_replays != 1 or read_counts() != expect_counts():
        raise AssertionError(f"replay: {step.graph_replays} replays, wrapper counts "
                             f"{read_counts()} (want none)")
    after = snapshot()
    restore(s0)
    zero_counts()
    eager = step.run_eager(groups[1])
    torch.cuda.synchronize()
    want = expect_counts(gn_relu_cconv=4 * k, gn_relu_cconv_bwd=4 * k,
                         joint_regressor=k, joint_regressor_bwd=k)
    if read_counts() != want:
        raise AssertionError(f"eager group launches {read_counts()} != {want}")
    bitwise = same(after) and all(torch.equal(replayed[m], eager[m]) for m in eager)
    rec["replay_equals_eager_bitwise"] = bitwise
    rec["max_abs_param_diff"] = max(float((x - y).abs().max()) for x, y in
                                    zip(state[:len(list(model.parameters()))], after)
                                    if x.dtype.is_floating_point)
    if not bitwise:
        log(rec)
        raise AssertionError("a replay of the graphed step differs from the eager steps")

    # the replay's kernels against the eager group's
    def replay_once():
        restore(s0)
        step(groups[1])

    def eager_once():
        restore(s0)
        step.run_eager(groups[1])

    # CUPTI drops a record now and then: a pair of traces that differ is
    # taken again, at most 3 times
    for attempt in range(3):
        eager_kernels = traced_kernels(eager_once)
        zero_counts()
        replay_kernels = traced_kernels(replay_once)
        if read_counts() != expect_counts():
            raise AssertionError(f"a traced replay counted launches: {read_counts()}")
        if replay_kernels == eager_kernels:
            break
        log({"check": "replay kernels", "attempt": attempt,
             "eager": sum(eager_kernels.values()), "replay": sum(replay_kernels.values())})
    else:
        raise AssertionError(f"replay kernels {replay_kernels} != eager {eager_kernels}")
    rec["kernels_per_group"] = sum(eager_kernels.values())
    rec["kernel_names"] = len(eager_kernels)

    # the learning rate reaches a replay
    step(groups[2])  # a replay at lr 1e-4
    s1 = snapshot()
    set_learning_rate(opt, 3e-5)
    step(groups[2])
    after_lr = snapshot()
    restore(s1)  # the learning rate too: set it again
    set_learning_rate(opt, 3e-5)
    step.run_eager(groups[2])
    rec["new_lr_replay_equals_eager"] = same(after_lr)
    if not rec["new_lr_replay_equals_eager"]:
        raise AssertionError("a replay after set_learning_rate differs from eager "
                             "steps at the new rate")
    restore(s1)
    set_learning_rate(opt, 1e-4)
    step.run_eager(groups[2])
    if same(after_lr):
        raise AssertionError("the replay at the new rate equals eager steps at the old")
    set_learning_rate(opt, 3e-5)

    # ms per step, eager and graphed
    def per_step_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (reps * k)

    rec["eager_ms_per_step"] = per_step_ms(lambda: step.run_eager(groups[1]))
    rec["graphed_ms_per_step"] = per_step_ms(lambda: step(groups[1]))
    rec["card"] = smi

    # dropout under the graph
    model.dropout = 0.5
    dstep = make_train_step(model, opt, fused=True, scan_steps=k)
    gen = torch.Generator(device=dev).manual_seed(11)
    dstep(groups[0], gen)
    s2 = snapshot()
    losses = {}
    for how, fn in (("replay", lambda: dstep(groups[1], gen)),
                    ("eager", lambda: dstep.run_eager(groups[1], gen))):
        losses[how] = []
        for _ in range(2):
            restore(s2)
            losses[how].append(fn()["loss"])
    if dstep.graph_replays != 2:
        raise AssertionError(f"dropout step: {dstep.graph_replays} replays, want 2")
    if any(torch.equal(*losses[how]) for how in losses):
        raise AssertionError(f"dropout 0.5: two draws gave the same losses {losses}")
    # the same generator state: a replay draws the eager masks (logged)
    restore(s2)
    gen.manual_seed(12)
    a = dstep(groups[1], gen)["loss"]
    restore(s2)
    gen.manual_seed(12)
    rec["dropout_replay_masks_equal_eager"] = torch.equal(a, dstep.run_eager(groups[1], gen)["loss"])
    rec["dropout_losses"] = {h: [v.tolist() for v in ls] for h, ls in losses.items()}
    model.dropout = 0.0
    rec["seconds"] = time.perf_counter() - t0
    log(rec)
    del step, dstep
    torch.cuda.empty_cache()
    return rec


def drive_grouped_train_paths(tmp, base_rows):
    """cli.train's grouped, resumed, phase-2 and profiled runs on the
    store and the run of drive_train_path (in tmp), each its own path with
    the counts set to 0 before it and read after:

    - train_graphed: --optim.steps-per-dispatch 4, against the ungrouped
      run's metrics.jsonl (rtol 1e-6): epoch 1's group runs eagerly and
      captures, epoch 2's is one replay;
    - train_accum_profiled: --optim.grad-accum 2, one epoch, finite, with
      --profile-dir, which must leave a trace holding B1-B4's kernels;
    - train_resume: --optim.stop-after-epochs 1, then --resume, against
      the ungrouped run: rows equal;
    - train_phase2: --optim.phase 2 --init-from the phase-1 best, 2
      epochs, --optim.curriculum-steps 2: finite; input_proj, f_movie and
      f_3D bit for bit those of best.msgpack, f_AR moved. Plain ops (h36x
      has no fused phase-2 step): no kernel launches.
    Returns {path: launch counts}."""
    import math

    from h36x_torch.cli.train import main as train_main
    from h36x_torch.train.checkpoint import load_params_only

    store, base = os.path.join(tmp, "store"), os.path.join(tmp, "runs")
    steps = TRAIN["train_clips"] // TRAIN["batch"]
    evals = math.ceil(TRAIN["val_clips"] / TRAIN["batch"])
    paths = {}

    def run(name, *flags, outdir=None):
        outdir = outdir or os.path.join(tmp, name)
        t0 = time.perf_counter()
        model, best = train_main(train_argv(store, outdir, *flags))
        torch.cuda.synchronize()
        return model, read_rows(outdir), time.perf_counter() - t0

    def finite(rows):
        return all(math.isfinite(r[k]) for r in rows
                   for k in ("train_loss", "train_mpjpe", "val_loss", "val_mpjpe"))

    def close(rows, want, rtol):
        return len(rows) == len(want) and all(
            abs(r[k] - w[k]) <= rtol * abs(w[k]) for r, w in zip(rows, want)
            for k in ROW_KEYS)

    # train_graphed
    zero_counts()
    _, rows, secs = run("graphed", "--optim.steps-per-dispatch", "4")
    paths["train_graphed"] = read_counts()
    want = expect_counts(gn_relu_cconv=4 * steps + 4 * TRAIN["epochs"] * evals,
                         gn_relu_cconv_bwd=4 * steps, joint_regressor=steps
                         + TRAIN["epochs"] * evals, joint_regressor_bwd=steps)
    grouping = [(r["graph_replays"], r["eager_steps"]) for r in rows]
    log({"phase": "train_graphed", "seconds": secs, "launches": paths["train_graphed"],
         "graph_replays_eager_steps": grouping,
         "max_rel_diff": max(abs(r[k] - w[k]) / abs(w[k]) for r, w in zip(rows, base_rows)
                             for k in ROW_KEYS), "metrics": rows})
    if paths["train_graphed"] != want or grouping != [(0, steps), (1, 0)]:
        raise AssertionError(f"graphed trainer: launches {paths['train_graphed']} "
                             f"(want {want}), replays/eager {grouping}")
    if not close(rows, base_rows, 1e-6):
        raise AssertionError("steps-per-dispatch 4 differs from the ungrouped run")

    # train_accum_profiled
    prof_dir = os.path.join(tmp, "trace")
    zero_counts()
    _, rows, secs = run("accum", "--optim.grad-accum", "2", "--optim.epochs", "1",
                        "--profile-dir", prof_dir)
    paths["train_accum_profiled"] = read_counts()
    traces = [os.path.join(prof_dir, f) for f in os.listdir(prof_dir)]
    with open(traces[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    # a kernel each of B1 (precise route), B2, B3 (precise), B4
    kinds = {k: any(k in n for n in names) for k in
             ("cconv_gemm", "gn_bwd", "regressor_kernel", "split_prologue")}
    want = expect_counts(gn_relu_cconv=4 * steps + 4 * evals, gn_relu_cconv_bwd=4 * steps,
                         joint_regressor=steps + evals, joint_regressor_bwd=steps)
    log({"phase": "train_accum_profiled", "seconds": secs,
         "launches": paths["train_accum_profiled"], "metrics": rows,
         "trace": os.path.basename(traces[0]), "trace_bytes": os.path.getsize(traces[0]),
         "trace_kernels_of": kinds})
    if (len(traces) != 1 or not all(kinds.values()) or not finite(rows)
            or [r["eager_steps"] for r in rows] != [steps // 2]
            or paths["train_accum_profiled"] != want):
        raise AssertionError("grad-accum / profile-dir run failed its checks")

    # train_resume
    zero_counts()
    cut = os.path.join(tmp, "resume")
    _, _, s1 = run("resume", "--optim.stop-after-epochs", "1", outdir=cut)
    _, rows, s2 = run("resume", "--resume", cut, outdir=cut)
    paths["train_resume"] = read_counts()
    keyed = [{k: r[k] for k in ("epoch", *ROW_KEYS)} for r in rows]
    log({"phase": "train_resume", "seconds": s1 + s2, "launches": paths["train_resume"],
         "metrics": keyed})
    if keyed != [{k: r[k] for k in ("epoch", *ROW_KEYS)} for r in base_rows]:
        raise AssertionError("stop-after + --resume differs from the uninterrupted run")

    # train_phase2
    best = os.path.join(base, "best.msgpack")
    zero_counts()
    model, rows, secs = run("phase2", "--optim.phase", "2", "--optim.fused", "false",
                            "--init-from", best, "--optim.curriculum-steps", "2")
    paths["train_phase2"] = read_counts()
    start = load_params_only(best, {k: v.cpu() for k, v in model.state_dict().items()})
    moved = {k: not torch.equal(v.cpu(), start[k]) for k, v in model.state_dict().items()}
    frozen_same = not any(m for k, m in moved.items() if not k.startswith("f_AR."))
    ar_moved = sum(m for k, m in moved.items() if k.startswith("f_AR."))
    log({"phase": "train_phase2", "seconds": secs, "launches": paths["train_phase2"],
         "metrics": rows, "frozen_modules_unchanged": frozen_same,
         "f_AR_leaves_moved": ar_moved,
         "f_AR_leaves": sum(k.startswith("f_AR.") for k in moved)})
    if not (finite(rows) and len(rows) == TRAIN["epochs"] and frozen_same and ar_moved):
        raise AssertionError("phase-2 run failed its checks")
    if paths["train_phase2"] != expect_counts():
        raise AssertionError(f"phase 2 launched kernels: {paths['train_phase2']}")
    return paths

# the artifact phase: the batch sizes each artifact is called at on the card,
# the bf16 artifact's bound against the f32 one (h36x's `--check` tolerance
# for a bf16 artifact, tests/test_export.py), the rollout's horizon, and the
# bursts of 16 concurrent requests each daemon mode is timed over
ART_BATCHES = (1, 5, 16, 32)
BF16_ARTIFACT_TOL = 2e-2
FORECAST = 25
DAEMON_ROUNDS = 8
BF16_LOSS_RTOL = 2e-2  # a bf16 step's loss against f32's (h36x's bound)


def serve_mode(predict_fn, feats, sock_dir, **server_kw):
    """One daemon run over `feats` (19 requests: DAEMON_ROUNDS bursts of the
    first 16 concurrently, then the last 3 one by one, then a stats query):
    (replies, stats)."""
    from h36x_torch.config import SEQ_LEN, ModelConfig
    from h36x_torch.serve_daemon import BatchingServer

    server = BatchingServer(predict_fn, seq_len=SEQ_LEN,
                            feature_dim=ModelConfig().feature_dim, max_batch=16,
                            max_wait_ms=5.0, **server_kw)
    return asyncio.run(drive_daemon(server, list(feats[:16]), list(feats[16:]),
                                    sock_dir, rounds=DAEMON_ROUNDS))


def drive_artifact_path(dev, g, tmp, card):
    """Export and the daemon's artifact mode at full width (the flagship
    ModelConfig, T 40; TF32 off):

    - h36x_torch.cli.export writes, from one seeded checkpoint, the forward
      at float32 (with --check on the card) and at bfloat16, and the
      25-step rollout: each one's seconds and file size;
    - each is loaded onto the card (load_artifact), every constant there,
      and called at batch 1, 5, 16 and 32: the f32 forward against the
      float32 plain engine and against the precise kernel engine (E2E_TOL),
      the bf16 one within BF16_ARTIFACT_TOL of the f32 one, the rollout
      against make_rollout_fn(use_kernels=False) (E2E_TOL);
    - each is served by BatchingServer in artifact mode (build_predict_fn
      (artifact=), bucket padding) with the counts set to 0 before and read
      after (the artifacts run plain ops: no launch): DAEMON_ROUNDS bursts
      of 16 concurrent requests, 3 sequential ones and a stats query, the
      rollout's replies split into (ctx, future); replies against the
      artifact called directly (f32 E2E_TOL, bf16 BF16_ARTIFACT_TOL);
    - checkpoint mode, precise and fast, serves the same requests: device
      ms per batch p50/p99 of all five beside each other.
    Returns the artifact serving's launch counts."""
    from h36x_torch.cli.export import main as export_main
    from h36x_torch.config import SEQ_LEN, ModelConfig
    from h36x_torch.export import load_artifact
    from h36x_torch.infer import make_fused_forward
    from h36x_torch.models.phd import PHDFor3DJoints, param_tree
    from h36x_torch.serve import make_rollout_fn
    from h36x_torch.serve_daemon import build_predict_fn
    from h36x_torch.train.checkpoint import save_params

    mc = ModelConfig()
    model = PHDFor3DJoints(generator=torch.Generator().manual_seed(2), device="cpu")
    ckpt = save_params(tmp, "best", model.state_dict(),
                       config={"model": dataclasses.asdict(mc),
                               "data": {"seq_len": SEQ_LEN}})
    params = param_tree(model.to(dev))
    arts, rec = {}, {"phase": "artifact", "card": card}
    for name, flags in (("f32", ["--check"]), ("bf16", ["--dtype", "bfloat16"]),
                        ("rollout", ["--kind", "rollout", "--forecast", str(FORECAST)])):
        path = os.path.join(tmp, f"{name}.pt2")
        t0 = time.perf_counter()
        export_main(["--model-path", str(ckpt), "--out", path, *flags])
        rec[f"{name}_cli_export_s"] = time.perf_counter() - t0
        with open(path + ".json") as f:
            rec[f"{name}_sidecar"] = json.load(f)
        rec[f"{name}_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        arts[name] = load_artifact(path)
        rec[f"{name}_load_s"] = time.perf_counter() - t0
        off = [str(t.device) for t in arts[name].tensors() if t.device.type != "cuda"]
        if off or not arts[name].tensors():
            raise AssertionError(f"{name} artifact: constants off the card: {off}")
    rec["bf16_over_f32_bytes"] = rec["bf16_bytes"] / rec["f32_bytes"]
    if not rec["bf16_over_f32_bytes"] < 0.6:
        raise AssertionError(f"bf16 artifact {rec['bf16_over_f32_bytes']:.3f}x the f32 one")

    plain = make_fused_forward(params, use_kernels=False, precise=True)
    kernels = make_fused_forward(params, use_kernels=True, precise=True)
    roll = make_rollout_fn(params, FORECAST, use_kernels=False, device=dev, precise=True)
    for b in ART_BATCHES:
        x = torch.randn(b, SEQ_LEN, mc.feature_dim, generator=g).to(dev)
        f32 = arts["f32"](x)
        compare(f"artifact f32 B={b} vs plain engine", f32, plain(x), E2E_TOL)
        compare(f"artifact f32 B={b} vs precise kernels", f32, kernels(x), E2E_TOL)
        bf16 = arts["bf16"](x)
        err = float((bf16 - f32).abs().max())
        log({"check": f"artifact bf16 B={b} vs f32", "max_abs_err": err,
             "tol": BF16_ARTIFACT_TOL, "dtype": str(bf16.dtype)})
        if not (bf16.dtype == torch.float32 and err <= BF16_ARTIFACT_TOL):
            raise AssertionError(f"bf16 artifact at B={b}: {err} from f32")
        ctx, fut = arts["rollout"](x)
        want_ctx, want_fut = roll(x)
        compare(f"artifact rollout B={b} ctx", ctx, want_ctx, E2E_TOL)
        compare(f"artifact rollout B={b} future", fut, want_fut, E2E_TOL)

    feats = torch.randn(19, SEQ_LEN, mc.feature_dim, generator=g).numpy()
    x = torch.from_numpy(feats).to(dev)
    total = dict.fromkeys(counted(), 0)
    for name in ("f32", "bf16", "rollout"):
        t0 = time.perf_counter()
        predict_fn, pad_to = build_predict_fn(artifact=os.path.join(tmp, f"{name}.pt2"),
                                              max_batch=16, warm=True)
        rec[f"{name}_daemon_ready_s"] = time.perf_counter() - t0
        zero_counts()
        replies, stats = serve_mode(predict_fn, feats, tmp, pad_to=pad_to,
                                    bucket_pad=True)
        launches = read_counts()
        if launches != expect_counts():
            raise AssertionError(f"artifact daemon {name} launched kernels: {launches}")
        for k, v in launches.items():
            total[k] += v
        direct = arts[name](x)
        tol = BF16_ARTIFACT_TOL if name == "bf16" else None
        if name == "rollout":
            got = [torch.from_numpy(np.stack([np.array(r[i]) for r in replies])).to(dev)
                   for i in (0, 1)]
            pairs = (("ctx", got[0], direct[0]), ("future", got[1], direct[1]))
        else:
            got = torch.from_numpy(np.stack([np.array(r) for r in replies])).to(dev)
            pairs = (("joints", got, direct),)
        for part, a, b in pairs:
            if tol is None:
                compare(f"artifact daemon {name} {part} vs artifact", a, b, E2E_TOL)
            else:
                err = float((a - b).abs().max())
                log({"check": f"artifact daemon {name} {part} vs artifact",
                     "max_abs_err": err, "tol": tol})
                if not err <= tol:
                    raise AssertionError(f"artifact daemon {name}: {err} from the artifact")
        if stats["requests"] != 16 * DAEMON_ROUNDS + 3:
            raise AssertionError(f"artifact daemon {name}: stats {stats}")
        rec[f"{name}_device_ms"] = stats["batch_device_ms"]
        rec[f"{name}_request_ms"] = stats["request_ms"]
        rec[f"{name}_mean_batch_rows"] = stats["mean_batch_rows"]
    for precise in (True, False):
        mode = "checkpoint_" + ("precise" if precise else "fast")
        predict_fn, _ = build_predict_fn(model_path=str(ckpt), max_batch=16, warm=True,
                                         precise=precise)
        _, stats = serve_mode(predict_fn, feats, tmp)
        rec[f"{mode}_device_ms"] = stats["batch_device_ms"]
        rec[f"{mode}_request_ms"] = stats["request_ms"]
        rec[f"{mode}_mean_batch_rows"] = stats["mean_batch_rows"]
    log(rec)
    return total


def drive_bf16_train_paths(dev, tmp, card):
    """--model.dtype bfloat16 on the store of drive_train_path (in tmp):

    - one phase-1 step (plain) of a bf16 and an f32 model from one seed on
      the store's first 32 train clips: the bf16 loss float32 and within
      BF16_LOSS_RTOL of f32's; ms per train step (forward, backward, AdamW;
      CUDA events) plain bf16, plain f32 and fused f32 at batch 32;
    - train_bf16: cli.train --model.dtype bfloat16 --optim.fused false for
      one epoch: finite; plain ops, no launch;
    - train_bf16_fused: --optim.fused true --model.dtype bfloat16 for
      TRAIN's epochs: its train steps launch B1-B4 exactly as the f32 fused
      run's (4 B1 + 4 B2 + 1 B3 + 1 B4 a step) and its train losses equal
      that run's (the kernels compute in float32 whatever the dtype, as
      h36x's fused step); its eval runs in bfloat16 on plain ops, as h36x's
      model.apply, so no eval batch launches.
    Returns {path: launch counts}."""
    import math

    from h36x_torch.cli.train import main as train_main
    from h36x_torch.config import TrainConfig
    from h36x_torch.data.features import FeatureClipDataset
    from h36x_torch.train.loop import build_model
    from h36x_torch.train.state import make_optimizer
    from h36x_torch.train.step import grads_and_metrics, make_train_step

    store = os.path.join(tmp, "store")
    steps = TRAIN["train_clips"] // TRAIN["batch"]
    batch = tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in FeatureClipDataset(
        store, subjects=[1]).get_batch(list(range(TRAIN["batch"])))[:4])
    rec = {"phase": "bf16_train", "card": card, "batch": TRAIN["batch"]}
    models = {}
    for name, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        cfg = TrainConfig()
        cfg.model.dtype = dtype
        cfg.model.dropout = 0.0
        models[name] = build_model(cfg, dev, torch.Generator().manual_seed(0))
        make_optimizer(models[name], 1e-4)
        m = grads_and_metrics(models[name], batch)
        rec[f"{name}_first_loss"] = float(m["loss"])
        rec[f"{name}_loss_dtype"] = str(m["loss"].dtype)
    rel = abs(rec["bf16_first_loss"] - rec["f32_first_loss"]) / abs(rec["f32_first_loss"])
    rec["first_loss_rel_diff"], rec["first_loss_rtol"] = rel, BF16_LOSS_RTOL
    if not (rel <= BF16_LOSS_RTOL and rec["bf16_loss_dtype"] == "torch.float32"):
        raise AssertionError(f"bf16 first step: {rec}")
    for name, fused in (("plain_bf16", False), ("plain_f32", False), ("fused_f32", True)):
        model = models[name.rsplit("_", 1)[1]]
        optimizer, _ = make_optimizer(model, 1e-4)
        step = make_train_step(model, optimizer, fused=fused)
        rec[f"step_ms_{name}"] = time_ms(lambda: step(batch), reps=10)
    log(rec)

    paths = {}
    base = read_rows(os.path.join(tmp, "runs"))
    zero_counts()
    t0 = time.perf_counter()
    train_main(train_argv(store, os.path.join(tmp, "bf16"), "--model.dtype", "bfloat16",
                          "--optim.fused", "false", "--optim.epochs", "1"))
    torch.cuda.synchronize()
    paths["train_bf16"] = read_counts()
    rows = read_rows(os.path.join(tmp, "bf16"))
    log({"phase": "train_bf16", "seconds": time.perf_counter() - t0,
         "launches": paths["train_bf16"], "metrics": rows})
    if paths["train_bf16"] != expect_counts() or len(rows) != 1 or not all(
            math.isfinite(rows[0][k]) for k in ("train_loss", "val_loss", "val_mpjpe")):
        raise AssertionError("the bf16 plain run failed its checks")

    zero_counts()
    t0 = time.perf_counter()
    train_main(train_argv(store, os.path.join(tmp, "bf16_fused"), "--model.dtype",
                          "bfloat16"))
    torch.cuda.synchronize()
    paths["train_bf16_fused"] = read_counts()
    rows = read_rows(os.path.join(tmp, "bf16_fused"))
    n = TRAIN["epochs"] * steps
    want = expect_counts(gn_relu_cconv=4 * n, gn_relu_cconv_bwd=4 * n,
                         joint_regressor=n, joint_regressor_bwd=n)
    same = [r["train_loss"] == b["train_loss"] for r, b in zip(rows, base)]
    log({"phase": "train_bf16_fused", "seconds": time.perf_counter() - t0,
         "launches": paths["train_bf16_fused"], "train_loss_equal_to_f32_fused": same,
         "metrics": rows})
    if paths["train_bf16_fused"] != want or len(rows) != len(base) or not all(same):
        raise AssertionError(f"the bf16 fused run: launches {paths['train_bf16_fused']} "
                             f"(want {want}), train losses equal to f32's {same}")
    return paths



def check_matmul_probe(dev):
    """B6 against its plain version: at 4096^3 (the probe's size) and at
    256 x 1024 x 512 (unequal sizes, 4 to 16 K steps), with every compiled
    tile, int8 bit for bit and bfloat16 by relative norm within
    BF16_REL_NORM (element-wise error logged). Then, per mode at 4096^3:
    the kernel's time with each tile, the plain version's, the library
    call's (torch.matmul, torch._int_mm) and the bound; for int8 also the device time of each of the call's two launches
    (the transposition of y, the GEMM; profiler). The kernels line carries
    the int8 mode (the probe's question) at the default tile and both modes
    under `modes`."""
    from h36x_torch.benchmarks.int8_kernel_probe import make_inputs
    from h36x_torch.ops.matmul_probe import TILES, probe_matmul, reference_matmul

    worst = worst_rel = 0.0
    for m, k, n in ((4096, 4096, 4096), (256, 1024, 512)):
        for mode in ("bf16", "int8"):
            x, y = make_inputs(f"kernel_{mode}", m, k, n, dev)
            want = reference_matmul(x, y)
            for tile in TILES:
                got = probe_matmul(x, y, tile)
                label = f"matmul_probe {mode} {m}x{k}x{n} tile {tile}"
                if mode == "int8":
                    torch.cuda.synchronize()
                    equal = bool(torch.equal(got, want))
                    log({"check": label, "bit_for_bit": equal,
                         "max_abs_want": int(want.abs().max())})
                    if not equal:
                        raise AssertionError(f"{label}: kernel disagrees with its "
                                             "plain version")
                else:
                    rec = compare(label, got.float(), want.float(), None, BF16_REL_NORM)
                    worst = max(worst, rec["max_abs_err"])
                    worst_rel = max(worst_rel, rec["rel_norm_err"])
    size = 4096
    modes = {}
    for mode, peak, lib in (("bf16", PEAK_BF16_FLOPS, torch.matmul),
                            ("int8", PEAK_INT8_OPS, torch._int_mm)):
        x, y = make_inputs(f"kernel_{mode}", size, size, size, dev)
        tile_ms = {str(tile): time_ms(lambda: probe_matmul(x, y, tile)) for tile in TILES}
        ms = tile_ms[str(TILES[0])]
        plain_ms = time_ms(lambda: reference_matmul(x, y), reps=5)
        library_ms = time_ms(lambda: lib(x, y))
        ops = 2 * size ** 3
        out_bytes = 2 if mode == "bf16" else 4
        nbytes = size * size * (2 * x.element_size() + out_bytes)
        bound_ms, bound_by = bound(ops, nbytes, peak)
        modes[mode] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "ms_by_tile": tile_ms,
                       "tera_ops_per_s": ops / ms / 1e9,
                       "library_tera_ops_per_s": ops / library_ms / 1e9,
                       "vs_library": library_ms / ms, "bound_share": bound_ms / ms}
        if mode == "int8":  # the transposition of y, then the GEMM
            per_launch = launch_ms(lambda: probe_matmul(x, y), 2)
            modes[mode]["launch_ms"] = per_launch
            modes[mode]["transpose_share"] = per_launch[0] / sum(per_launch)
        log({"check": f"matmul_probe timing {mode} {size}^3 tile {TILES[0]}",
             **modes[mode]})
    return {"name": "matmul_probe", "route": "cuda",
            "source": "h36x_torch/ops/csrc/matmul_probe.cu",
            "replaces": "benchmarks/int8_pallas_probe.py:43",
            "max_abs_err": worst, "max_rel_norm_err": worst_rel,
            **{key: modes["int8"][key] for key in ("ms", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms")},
            "modes": modes,
            "shape": f"M=K=N={size}, tile {TILES[0]}; headline numbers: int8 -> int32 "
                     "(bit for bit); max_abs_err: the bf16 mode's",
            "tol": {"int8": "bit for bit", "bf16_rel_norm": BF16_REL_NORM}}


def drive_probe_path():
    """B6's main path: the probe's own entry point, once."""
    from h36x_torch.benchmarks.int8_kernel_probe import MODES, main as probe_main

    zero_counts()
    results = probe_main([])
    torch.cuda.synchronize()
    launches = read_counts()
    bursts, iters = 7, 24  # a warm-up burst and 6 timed ones, per kernel mode
    want = expect_counts(matmul_probe=2 * bursts * iters)
    log({"phase": "probe", "launches": launches,
         **{mode: {"ms": dt * 1e3, "tera_ops_per_s": rate}
            for mode, (dt, rate) in results.items()}})
    if launches != want or set(results) != set(MODES):
        raise AssertionError(f"probe launches {launches} != {want}")
    return launches


def npz_fields(name, got, want, fields):
    """Two NPZ payloads of one call: the same fields, the ground truth
    equal, predictions of the expected shapes."""
    if set(got) != set(want) or set(got) != {"joints3d", "meta", *fields}:
        raise AssertionError(f"{name}: fields {sorted(got)} vs {sorted(want)}")
    if not np.array_equal(got["joints3d"], want["joints3d"]):
        raise AssertionError(f"{name}: joints3d differ")
    for field, shape in fields.items():
        if tuple(got[field].shape) != shape:
            raise AssertionError(f"{name}: {field} is {got[field].shape}, not {shape}")


def npz_against_plain(name, got, want, fields):
    """A kernel run's NPZ payload against the plain engines' on the same
    call: the same fields, the ground truth equal, predictions (future
    frames included) finite and within E2E_TOL."""
    npz_fields(name, got, want, fields)
    out = {}
    for field in fields:
        a, b = torch.from_numpy(got[field]), torch.from_numpy(want[field])
        out[field] = compare(f"{name} {field} kernels vs plain engines", a, b,
                             E2E_TOL)["max_abs_err"]
    return out


def drive_predict_path(dev, g, tmp):
    """The prediction path end to end at full width: h36x_torch.cli.predict
    in its three modes over a store and a seeded checkpoint, each precise
    (held to the plain engines at E2E_TOL) and at its default, fast (by
    relative norm against the plain engines in fast mode and in float32),
    each run with the counts set to 0 just before it and read just after.
    Then one predictor by hand (exact pushes, a forecast, the freeze, frozen
    pushes through the captured graph, a forecast after it) in fast mode
    against the plain engines in both modes, the per-push, per-rollout and
    per-forecast times on both routes, and the results stage
    (evaluate_test, dump_debug_batch)."""
    from h36x_torch.cli.predict import main as predict_main
    from h36x_torch.config import SEQ_LEN, ModelConfig
    from h36x_torch.data.features import FeatureClipDataset
    from h36x_torch.models.phd import PHDFor3DJoints, param_tree
    from h36x_torch.serve import StreamingPredictor, make_rollout_fn
    from h36x_torch.train.checkpoint import save_params
    from h36x_torch.train.results import dump_debug_batch, evaluate_test

    mc = ModelConfig()
    store = os.path.join(tmp, "store")
    write_store(store, g)
    model = PHDFor3DJoints(generator=torch.Generator().manual_seed(3), device="cpu")
    ckpt = save_params(tmp, "best", model.state_dict(),
                       config={"model": dataclasses.asdict(mc),
                               "data": {"seq_len": SEQ_LEN}})
    clips, steps, t, window = 8, 25, SEQ_LEN, SEQ_LEN // 2
    n_ar, n_mv = 2 * mc.ar_num_blocks, 2 * mc.num_blocks
    rollout_b1 = n_mv + steps * n_ar  # 4 + 150 at the flagship config
    joints = (clips, t, 17, 3)
    future = (clips, steps, 17, 3)
    runs = {
        "batch_rollout": (["--clips", str(clips), "--forecast", str(steps)],
                          {"predicted3djoints": joints, "future3djoints": future},
                          expect_counts(gn_relu_cconv=rollout_b1, joint_regressor=2)),
        # per clip: `window` exact pushes (4 B1 + 1 B3), then the freeze, then
        # t - window frozen pushes (the first eager, 1 B3; the rest graph
        # replays, which no wrapper counts), then the forecast (4 + 150 B1,
        # 1 B3)
        "streaming_freeze": (["--streaming", "--freeze", "--forecast", str(steps)],
                             {"predicted3djoints": joints, "future3djoints": future},
                             expect_counts(
                                 gn_relu_cconv=clips * (window * n_mv + rollout_b1),
                                 joint_regressor=clips * (window + 2))),
        "forward": (["--forecast", "0"], {"predicted3djoints": joints},
                    expect_counts(gn_relu_cconv=n_mv, joint_regressor=1)),
    }
    total = dict.fromkeys(counted(), 0)
    for name, (flags, fields, want) in runs.items():
        argv = ["--features-root", store, "--model-path", str(ckpt), "--subjects", "5",
                *flags]
        plain = {}
        for precise in (True, False):
            mode = "precise" if precise else "fast"
            out = os.path.join(tmp, f"{name}_{mode}")
            zero_counts()
            t0 = time.perf_counter()
            got = predict_main([*argv, "--out", f"{out}.npz"], precise=precise)
            seconds = time.perf_counter() - t0
            launches = read_counts()
            plain[mode] = predict_main([*argv, "--out", f"{out}_plain.npz"],
                                       use_kernels=False, precise=precise)
            if read_counts() != launches:
                raise AssertionError(f"predict {name}: the plain engines launched a kernel")
            if precise:
                errs = npz_against_plain(f"predict {name}", got, plain[mode], fields)
            else:
                npz_fields(f"predict {name} fast", got, plain[mode], fields)
                errs = {f: path_rel_norms(f"predict {name} {f}",
                                          torch.from_numpy(got[f]),
                                          torch.from_numpy(plain["fast"][f]),
                                          torch.from_numpy(plain["precise"][f]))
                        ["rel_norm_err"] for f in fields}
            saved = np.load(f"{out}.npz", allow_pickle=True)
            if set(saved.files) != set(got) or len(saved["meta"]) != clips:
                raise AssertionError(f"predict {name}: saved NPZ holds {saved.files}")
            log({"phase": f"predict {name} {mode}", "seconds": seconds,
                 "launches": launches, "err_vs_plain": errs})
            if launches != want:
                raise AssertionError(f"predict {name}: launches {launches} != {want}")
            for k, v in launches.items():
                total[k] += v

    # one predictor by hand: exact launch counts per call, ms per push
    params = param_tree(model.to(dev))
    ds = FeatureClipDataset(store, subjects=[5], test_set=True)
    feats = np.asarray(ds.get_batch(list(range(clips)))[0], np.float32)

    def counted_call(fn, want_b1, want_b3, what):
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3  # push and forecast end on the host
        want = expect_counts(gn_relu_cconv=want_b1, joint_regressor=want_b3)
        if read_counts() != want:
            raise AssertionError(f"{what}: launches {read_counts()} != {want}")
        return out, ms

    def drive(sp, counts):
        """window exact pushes, a forecast, the freeze, window frozen pushes
        (the first runs eagerly and captures the graph, the rest replay
        it), a forecast: (joints of every push, the two forecasts, ms of
        each push and forecast)."""
        pushes, ms = [], {"exact": [], "frozen": [], "forecast": []}
        for i in range(t):
            out, dt = counted_call(lambda: sp.push(feats[0, i]), n_mv if counts else 0,
                                   1 if counts else 0, "exact push")
            pushes.append(out)
            ms["exact"].append(dt)
        fc0, dt = counted_call(lambda: sp.forecast(steps), rollout_b1 if counts else 0,
                               1 if counts else 0, "forecast")
        ms["forecast"].append(dt)
        counted_call(sp.freeze, 0, 0, "freeze")
        for i in range(t):
            replays = sp.replays
            out, dt = counted_call(lambda: sp.push(feats[1, i]), 0,
                                   1 if counts and i == 0 else 0, "frozen push")
            if sp.replays != replays + (i > 0):
                raise AssertionError(f"frozen push {i}: replays {replays} -> {sp.replays}")
            pushes.append(out)
            ms["frozen"].append(dt)
        fc1, dt = counted_call(lambda: sp.forecast(steps), rollout_b1 if counts else 0,
                               1 if counts else 0, "forecast after the freeze")
        ms["forecast"].append(dt)
        return (torch.from_numpy(np.stack(pushes)), torch.from_numpy(np.stack([fc0, fc1])),
                ms)

    def replay_kernels(sp, reps=5):
        """Kernel names of `reps` frozen pushes, each a replay of sp's
        graph, from a torch.profiler trace (CUPTI's kernel records; the
        wrappers do not see a replay): B3's kernels once a push, no B1
        kernel. A trace that lost some of B3's kernel records (CUPTI drops
        records now and then, as launch_ms finds) is taken again, at most 3
        times; a B1 kernel, a wrapper count or a push that did not replay
        fails at once. Returns the counts of B3's kernels."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        b3 = (("cast_phi", "chain_kernel") if not sp.precise else ("regressor_kernel",))
        b1 = ("gn_stats", "cconv_gemm", "gn_act_taps", "h36x_hopper::gemm_kernel")
        for attempt in range(3):
            zero_counts()
            replays = sp.replays
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for i in range(reps):
                    sp.push(feats[2, i])
                torch.cuda.synchronize()
            names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
            got = {k: sum(k in n for n in names) for k in (*b3, *b1)}
            log({"check": f"frozen push replays ({'precise' if sp.precise else 'fast'})",
                 "attempt": attempt, "pushes": reps, "replays": sp.replays - replays,
                 "kernel_events": len(names), "kernels": got,
                 "wrapper_counts": read_counts()})
            if (sp.replays - replays != reps or read_counts() != expect_counts()
                    or any(got[k] for k in b1)):
                raise AssertionError(f"frozen push replays: {got}, {len(names)} kernel events")
            if all(got[k] == reps for k in b3):
                return got
        raise AssertionError(f"frozen push replays: {got}, {len(names)} kernel events "
                             "in each of 3 traces")

    kw = dict(window=t, feature_dim=mc.feature_dim, device=dev)
    streams, replayed = {}, {}
    for mode, extra, counts in (("fast", {}, True), ("precise", {"precise": True}, True),
                                ("fast_plain", {"use_kernels": False}, False),
                                ("f32_plain", {"use_kernels": False, "precise": True},
                                 False)):
        sp = StreamingPredictor(params, **extra, **kw)
        streams[mode] = drive(sp, counts)
        if counts:
            replayed[mode] = replay_kernels(sp)
    for i, what in ((0, "pushes (exact and frozen)"), (1, "forecasts")):
        path_rel_norms(f"stream {what}", streams["fast"][i], streams["fast_plain"][i],
                       streams["f32_plain"][i])
        compare(f"stream {what} precise kernels vs plain", streams["precise"][i],
                streams["f32_plain"][i], E2E_TOL)

    def push_ms(mode):
        ms = streams[mode][2]
        return {"push_exact_ms_median": float(np.median(ms["exact"][1:])),
                "push_frozen_ms_median": float(np.median(ms["frozen"][1:])),
                "first_frozen_push_ms": ms["frozen"][0],
                "forecast_ms": ms["forecast"]}

    rollouts = {"fast": make_rollout_fn(params, steps, device=dev),
                "precise": make_rollout_fn(params, steps, device=dev, precise=True),
                "fast_plain": make_rollout_fn(params, steps, use_kernels=False,
                                              device=dev),
                "f32_plain": make_rollout_fn(params, steps, use_kernels=False,
                                             device=dev, precise=True)}

    def timed_rollout(fn):
        ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(feats)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms[1:])), torch.cat([o.reshape(clips, -1) for o in out], 1)

    rolled = {mode: timed_rollout(fn) for mode, fn in rollouts.items()}
    path_rel_norms("rollout (context and future joints)", rolled["fast"][1],
                   rolled["fast_plain"][1], rolled["f32_plain"][1])
    compare("rollout precise kernels vs plain", rolled["precise"][1],
            rolled["f32_plain"][1], E2E_TOL)
    timing = {"phase": "predict timing", "card": torch.cuda.get_device_name(0),
              "clips": clips, "steps": steps, "window": t,
              **{f"rollout_ms_{mode}": r[0] for mode, r in rolled.items()},
              "fast": push_ms("fast"), "precise": push_ms("precise"),
              "fast_plain": push_ms("fast_plain"), "pushes": 2 * t,
              "replay_kernels": replayed}
    log(timing)
    if not timing["fast"]["push_frozen_ms_median"] < timing["fast"]["push_exact_ms_median"]:
        raise AssertionError(f"the frozen push is not faster than the exact push: {timing}")

    # the results stage on the card
    zero_counts()
    got = evaluate_test(model, ds, batch_size=16)
    launches = read_counts()
    want_metrics = evaluate_test(model, ds, batch_size=16, use_kernels=False)
    batches = -(-len(ds) // 16)
    want = expect_counts(gn_relu_cconv=n_mv * batches, joint_regressor=batches)
    log({"phase": "evaluate_test", "clips": len(ds), "metrics": got,
         "plain_metrics": want_metrics, "launches": launches})
    if launches != want or read_counts() != launches:
        raise AssertionError(f"evaluate_test launches {launches} != {want}")
    if not (np.all(np.isfinite(got)) and np.allclose(got, want_metrics, rtol=1e-4)
            and got[2] == got[0] and got[3] == 0.0):
        raise AssertionError(f"evaluate_test {got} vs plain {want_metrics}")
    for k, v in launches.items():
        total[k] += v
    payload = dump_debug_batch(ds, os.path.join(tmp, "debug_batch.npz"), batch_size=8)
    saved = np.load(os.path.join(tmp, "debug_batch.npz"), allow_pickle=True)
    if (set(saved.files) != {"video", "joints3d", "joints2d", "cam_K", "meta"}
            or saved["video"].shape != (8, t, mc.feature_dim)
            or not np.array_equal(saved["video"], payload["video"])):
        raise AssertionError(f"dump_debug_batch wrote {saved.files}")
    log({"check": "dump_debug_batch", "fields": sorted(saved.files), "ok": True})
    return total


def bottleneck_work(n, side, c_in, c_mid, c_out, itemsize):
    """(FLOPs, bytes) of one fused bottleneck over n frames: the three
    contractions and the projection; x, the weights and biases read once,
    the output written once."""
    weights = c_in * c_mid + 9 * c_mid * c_mid + c_mid * c_out
    biases = 2 * c_mid + c_out
    if c_in != c_out:
        weights += c_in * c_out
        biases += c_out
    px = n * side * side
    return 2 * px * weights, itemsize * (px * (c_in + c_out) + weights) + 4 * biases


def bottleneck_weights(c_in, c_mid, c_out, gd, dev):
    """Random folded weights (f32, h36x's layouts, 1/sqrt(fan-in) scale); a
    projection whenever C_in != C_out, as in ResNet-50."""

    def init(shape, fan_in):
        return torch.randn(shape, generator=gd, device=dev) / fan_in ** 0.5

    def bias(c):
        return 0.1 * torch.randn(c, generator=gd, device=dev)

    f = {"w1": init((c_in, c_mid), c_in), "b1": bias(c_mid),
         "w2": init((3, 3, c_mid, c_mid), 9 * c_mid), "b2": bias(c_mid),
         "w3": init((c_mid, c_out), c_mid), "b3": bias(c_out)}
    if c_in != c_out:
        f["wp"], f["bp"] = init((c_in, c_out), c_in), bias(c_out)
    return f


def check_bottleneck(dev, n_dispatch):
    """B5 against its plain version at the 13 stride-1 blocks' shapes (the
    projection block layer1_0 included) at N 1 and at the dispatch size, in
    float32 (element-wise, KERNEL_TOL) and bfloat16 (relative norm,
    BF16_REL_NORM), and at two odd sizes, each launch counted on the route
    bottleneck_route names; then, in bfloat16 at the dispatch size, each
    shape's route, time, plain version's time, bound, the general route's
    time on the same inputs (the earlier, mma.sync design, which stays the
    route of float32 and odd widths; uncounted) and each of its three
    launches' device time (profiler). The kernels line takes the sums over
    one forward's 13 blocks."""
    from h36x_torch.ops.bottleneck import (
        bottleneck_route,
        fused_bottleneck,
        launch_on_route,
        prepare_bottleneck,
        reference_bottleneck,
    )

    gd = torch.Generator(device=dev).manual_seed(5)
    cases = [(name, side, side, c_in, c_mid, c_out, n)
             for name, _, side, c_in, c_mid, c_out in B5_SHAPES for n in (1, n_dispatch)]
    cases += [("odd 9x9", 9, 9, 64, 16, 64, 3), ("odd 9x9 projection", 9, 9, 32, 16, 64, 3),
              ("odd 5x3", 5, 3, 20, 12, 36, 2)]
    worst = worst_rel = worst_f32 = 0.0
    for name, h, w, c_in, c_mid, c_out, n in cases:
        folded = bottleneck_weights(c_in, c_mid, c_out, gd, dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.relu(torch.randn(n, h * w, c_in, generator=gd, device=dev)).to(dtype)
            p = prepare_bottleneck(folded, dtype, dev)
            route = bottleneck_route(dtype, c_in, c_mid, c_out)
            before = dict(fused_bottleneck.launches_by_route)
            got = fused_bottleneck(x, p, h, w)
            grown = {r: v - before[r] for r, v in fused_bottleneck.launches_by_route.items()}
            if grown != {r: int(r == route) for r in grown}:
                raise AssertionError(f"bottleneck {name} {dtype}: launches {grown}, "
                                     f"want one on the {route} route")
            want = reference_bottleneck(x, p, h, w)
            label = (f"bottleneck {name} N={n} {h}x{w} {c_in}/{c_mid}/{c_out} {dtype} "
                     f"({route})")
            if dtype == torch.float32:
                rec = compare(label, got, want, KERNEL_TOL)
                worst_f32 = max(worst_f32, rec["max_abs_err"])
            else:
                rec = compare(label, got.float(), want.float(), None, BF16_REL_NORM)
            worst = max(worst, rec["max_abs_err"])
            worst_rel = max(worst_rel, rec["rel_norm_err"])
    per_shape = []
    totals = {"ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0, "general_ms": 0.0}
    for name, count, side, c_in, c_mid, c_out in B5_SHAPES:
        p = prepare_bottleneck(bottleneck_weights(c_in, c_mid, c_out, gd, dev),
                               torch.bfloat16, dev)
        x = torch.relu(torch.randn(n_dispatch, side * side, c_in, generator=gd,
                                   device=dev)).bfloat16()
        ms = time_ms(lambda: fused_bottleneck(x, p, side, side))
        plain_ms = time_ms(lambda: reference_bottleneck(x, p, side, side))
        general_ms = time_ms(lambda: launch_on_route(x, p, side, side, "general"))
        flops, nbytes = bottleneck_work(n_dispatch, side, c_in, c_mid, c_out, 2)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        # the route's three GEMMs: x @ W1, the 3x3, the last 1x1 with the residual
        per_launch = launch_ms(lambda: fused_bottleneck(x, p, side, side), 3)
        rec = {"blocks": name, "per_forward": count, "N": n_dispatch,
               "shape": f"{side}x{side} {c_in}/{c_mid}/{c_out}",
               "route": bottleneck_route(torch.bfloat16, c_in, c_mid, c_out), "ms": ms,
               "general_ms": general_ms, "speedup": general_ms / ms,
               "launch_ms": per_launch,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms}
        log({"check": "bottleneck timing", **rec})
        per_shape.append(rec)
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("flops", flops),
                       ("bytes", nbytes), ("general_ms", general_ms)):
            totals[key] += count * v
    bound_ms, bound_by = bound(totals["flops"], totals["bytes"], PEAK_BF16_FLOPS)
    return {"name": "fused_bottleneck", "route": "cuda",
            "source": "h36x_torch/ops/csrc/bottleneck.cu",
            "replaces": "h36x/ops/pallas_bottleneck.py:87",
            "max_abs_err": worst, "max_abs_err_f32": worst_f32,
            "max_rel_norm_err": worst_rel, "ms": totals["ms"],
            "general_ms": totals["general_ms"],
            "plain_ms": totals["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "per_shape": per_shape,
            "shape": f"the 13 stride-1 blocks of one ResNet-50 forward, N={n_dispatch} "
                     "frames at 224 px, bfloat16",
            "tol": {"f32": KERNEL_TOL, "bf16_rel_norm": BF16_REL_NORM}}


def check_backbone(dev, n):
    """The full ResNet-50 at 224 px on the same u8 frames: the folded engine
    (13 B5 launches, all on the hopper route) and the plain module (cuDNN),
    both bfloat16, against
    each other and against the float32 module (TF32 off) by relative norm;
    then each engine's frames/s."""
    from h36x_torch.extract.pipeline import make_feature_fn
    from h36x_torch.models.resnet import ResNet50
    from h36x_torch.ops.bottleneck import fused_bottleneck

    gd = torch.Generator(device=dev).manual_seed(6)
    frames = torch.randint(0, 256, (n, 224, 224, 3), generator=gd, device=dev,
                           dtype=torch.uint8)
    ref = make_feature_fn(ResNet50(dtype=torch.float32, device=dev), "flax")(frames)
    model = ResNet50(dtype=torch.bfloat16, device=dev)
    engines = {"opt": make_feature_fn(model, "opt"), "flax": make_feature_fn(model, "flax")}
    before = fused_bottleneck.launches
    before_hopper = fused_bottleneck.launches_by_route["hopper"]
    got = {name: fn(frames) for name, fn in engines.items()}
    torch.cuda.synchronize()
    hopper = fused_bottleneck.launches_by_route["hopper"] - before_hopper
    if fused_bottleneck.launches - before != 13 or hopper != 13:
        raise AssertionError(f"one opt forward launched B5 "
                             f"{fused_bottleneck.launches - before} times ({hopper} on the "
                             "hopper route), not 13, all hopper")
    compare("backbone bf16: opt (B5) vs flax (cuDNN)", got["opt"], got["flax"], None,
            BACKBONE_REL_NORM)
    for name in engines:
        compare(f"backbone bf16 {name} vs float32 module", got[name], ref, None,
                BACKBONE_REL_NORM)
    rec = {"phase": "backbone", "frames": n, "tol_rel_norm": BACKBONE_REL_NORM,
           "b5_launches": 13, "b5_hopper_launches": hopper}
    for name, fn in engines.items():
        ms = time_ms(lambda: fn(frames), reps=5)
        rec[f"{name}_ms"] = ms
        rec[f"{name}_frames_per_s"] = n / ms * 1e3
    log(rec)
    return rec


class SyntheticVideos:
    """An in-memory, video-structured clip source, made from a seed, with
    the interface of tests/test_dedup.py::FakeOverlapDataset (`clips`,
    `clip_annotations`, `video_groups`, `video_joints2d`, `__getitem__`)
    and the sequential cursor of the real dataset (`open_video`): u8 frames
    at H36M's raw size, a person's 2D joints drifting slowly, H36M-like
    intrinsics. It stands in for the mp4 tree because the machine with the
    card has no OpenCV to decode one."""

    class Cursor:
        def __init__(self, frames):
            self.frames = frames

        def get(self, start, end):
            return self.frames[start:end]

        def close(self):
            pass

    def __init__(self, seed, videos, frames, raw, seq_len, stride):
        from h36x_torch.data.clips import ClipIndex

        rng = np.random.default_rng(seed)
        self.frames, self.j2d, self.j3d, self.clips = [], [], [], []
        for v in range(videos):
            self.frames.append(rng.integers(0, 256, (frames, raw, raw, 3), dtype=np.uint8))
            centre = raw / 2 + rng.uniform(-100, 100, 2)
            pose = rng.uniform(-1, 1, (1, 17, 2)) * [100, 200]
            drift = np.cumsum(rng.normal(0, 2, (frames, 1, 2)), axis=0)
            self.j2d.append((centre + pose + drift).astype(np.float32))
            self.j3d.append((300 * rng.normal(size=(frames, 17, 3))).astype(np.float32))
            cam = {"f": np.array([1145.0, 1144.0]), "c": np.array([raw / 2, raw / 2]),
                   "k": np.zeros(5), "rt": np.eye(3), "t": np.zeros(3)}
            for start in range(0, frames - seq_len + 1, stride):
                self.clips.append(ClipIndex(
                    video_path=f"synthetic_{v}.mp4", gt_path=f"synthetic_{v}.pkl",
                    subject=1 + v, action="Walking", cam="cam_0", cam_params=cam,
                    start=start, end=start + seq_len, video_idx=v))

    def __len__(self):
        return len(self.clips)

    def clip_annotations(self, i):
        ci = self.clips[i]
        v = ci.video_idx
        return (self.j3d[v][ci.start:ci.end].copy(), self.j2d[v][ci.start:ci.end].copy(),
                ci.cam_params, ci)

    def video_groups(self):
        groups = {}
        for i, ci in enumerate(self.clips):
            groups.setdefault(ci.video_idx, []).append(i)
        return [groups[v] for v in sorted(groups)]

    def video_joints2d(self, video_idx):
        return self.j2d[video_idx]

    def open_video(self, video_idx):
        return self.Cursor(self.frames[video_idx])

    def __getitem__(self, i):
        j3d, j2d, cam, ci = self.clip_annotations(i)
        return self.frames[ci.video_idx][ci.start:ci.end], j3d, j2d, cam, ci


def frames_per_dispatch() -> int:
    """The unique-frame scheduler's default device batch: batch_size *
    seq_len * 3 pixel variants."""
    return EXTRACT["batch_size"] * EXTRACT["seq_len"] * 3


def drive_extract_path(dev, dataset, out, engine, partition=""):
    """Extraction end to end through run_extract, the function
    h36x_torch.cli.extract calls, with the counts set to 0 just before it
    and read just after: B5 must launch 13 times per dispatch with the `opt`
    engine and never with `flax`, and no other kernel launches. With
    `partition` ("i/N") only the clips i::N, at least one dispatch."""
    import math

    from h36x_torch.config import ExtractConfig
    from h36x_torch.extract.pipeline import run_extract, store_provenance
    from h36x_torch.ops.bottleneck import fused_bottleneck

    e = EXTRACT
    if store_provenance()["crop_backend"] != "native":
        raise AssertionError("the port's native crop library did not build")
    cfg = ExtractConfig(out=out, seq_len=e["seq_len"], stride=e["stride"],
                        resize=e["resize"], batch_size=e["batch_size"], num_workers=4,
                        augment=True, shard_size=8, shuffle_pool=16, engine=engine,
                        partition=partition)
    zero_counts()
    t0 = time.perf_counter()
    summary = run_extract(cfg, dataset=dataset, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    dispatches = math.ceil(summary["backbone_frames"] / frames_per_dispatch())
    want = expect_counts(fused_bottleneck=13 * dispatches if engine == "opt" else 0)
    by_route = dict(fused_bottleneck.launches_by_route)
    if by_route["hopper"] != want["fused_bottleneck"]:
        raise AssertionError(f"extract {engine}: B5 launches by route {by_route}")
    # the run's own rate (summary["seconds"]: from the backbone's load to
    # the index) and the call's wall time, the load included
    log({"phase": f"extract {engine}" + (f" partition {partition}" if partition else ""),
         "call_seconds": seconds,
         "run_seconds": summary["seconds"], "launches": launches,
         "b5_launches_by_route": by_route, "dispatches": dispatches,
         "clips_per_s": summary["clips_per_sec"],
         "backbone_frames_per_s": summary["backbone_frames"] / summary["seconds"],
         **{k: summary[k] for k in ("n_clips", "n_shards", "backbone_frames",
                                    "dedup_ratio", "crop_scope", "jitter_key")}})
    if launches != want or dispatches < (1 if partition else 2):
        raise AssertionError(f"extract {engine}: launches {launches} != {want} "
                             f"over {dispatches} dispatches")
    i, n = (int(v) for v in partition.split("/")) if partition else (0, 1)
    if (summary["n_clips"], summary["crop_scope"], summary["jitter_key"]) != (
            len(range(len(dataset))[i::n]), "video", "video"):
        raise AssertionError(f"extract {engine}: {summary}")
    return launches, summary


def compare_stores(opt_root, flax_root, dev):
    """The two engines' stores: both pass verify_store; index.json, every
    non-feature array and every meta entry byte-identical; features finite
    and within BACKBONE_REL_NORM of each other by relative norm. Then one
    batch of the opt store, read through h36x_torch.data.features, runs
    through the PHD forward."""
    from h36x_torch.data.features import FeatureClipDataset
    from h36x_torch.data.shards import load_index, read_shard, shard_path, verify_store
    from h36x_torch.infer import make_fused_forward
    from h36x_torch.models.phd import PHDFor3DJoints, param_tree

    for root in (opt_root, flax_root):
        rep = verify_store(root)
        if rep["errors"] or not rep["arrays_checked"]:
            raise AssertionError(f"verify_store({root}): {rep}")
    index = [open(os.path.join(r, "index.json"), "rb").read() for r in (opt_root, flax_root)]
    if index[0] != index[1]:
        raise AssertionError("index.json differs between the engines")
    diff2 = ref2 = 0.0
    finite = True
    n_shards = load_index(opt_root)["n_shards"]
    for sid in range(n_shards):
        a = read_shard(shard_path(opt_root, sid), mmap=False)
        b = read_shard(shard_path(flax_root, sid), mmap=False)
        if a.keys() != b.keys() or a["meta"] != b["meta"]:
            raise AssertionError(f"shard {sid}: meta differs between the engines")
        for name in a:
            if name in ("meta", "n_vars", "feats"):
                continue
            if a[name].dtype != b[name].dtype or a[name].tobytes() != b[name].tobytes():
                raise AssertionError(f"shard {sid}: {name} differs between the engines")
        fa, fb = torch.from_numpy(a["feats"]).double(), torch.from_numpy(b["feats"]).double()
        finite &= bool(torch.isfinite(fa).all() and torch.isfinite(fb).all())
        diff2 += float(((fa - fb) ** 2).sum())
        ref2 += float((fb ** 2).sum())
    rel = (diff2 / ref2) ** 0.5 if ref2 > 0 else float("inf")
    log({"check": "stores opt vs flax", "shards": n_shards, "feats_rel_norm": rel,
         "tol_rel_norm": BACKBONE_REL_NORM, "finite": finite})
    if not finite or rel > BACKBONE_REL_NORM:
        raise AssertionError(f"store features: finite {finite}, rel norm {rel}")
    ds = FeatureClipDataset(opt_root, augment=True)
    feats = ds.get_batch(list(range(8)))[0]
    model = PHDFor3DJoints(generator=torch.Generator().manual_seed(2), device=dev)
    joints = make_fused_forward(param_tree(model))(torch.from_numpy(feats).to(dev))
    if joints.shape != (8, feats.shape[1], 17, 3) or not torch.isfinite(joints).all():
        raise AssertionError(f"PHD forward on the store: {tuple(joints.shape)}")
    log({"check": "store -> PHD forward", "rows": len(ds), "joints": list(joints.shape),
         "ok": True})


# -- slice 10: ingest, the crop-resize front ends, partitioned extraction and
# the merge, the store's bf16 and .pt forms, 2-process data-parallel training

# the raw tree of the ingest phase: 1 subject x 2 actions x 2 trials x the 4
# official cameras, 1000 frames of 32 joints each
INGEST = dict(subject=1, actions=(1, 2), trials=(1, 2), frames=1000)
CROP = dict(frames=40, raw=1000, box=(130, 210, 600, 600), out=224)
CROP_TOL = 1e-5  # the device forms against the CPU and each other
NATIVE_TOL = 1.0 / 255 + 1e-6  # against the native crop's uint8 (one step)
# resize_bilinear against F.interpolate on the card: interpolate's CUDA kernel
# takes its source coordinates in float32 (2^-24 relative: ~6e-5 px at 1000
# px, times a neighbour difference up to 1), the grid here in float64
INTERP_TOL = 2.5e-4


def write_raw_tree(root, seed=0) -> dict:
    """A raw Human3.6M tree in the official layout, written here from a
    seed: metadata.xml (the w0 calibration block of 11 subjects x 4 cameras
    and the action mapping), per (action, trial, camera) a stub .mp4 under
    Videos/ and .npz 2D and 3D poses (1, frames, 32 * dim) under
    MyPoseFeatures/. The 2D joints are pixels of a 1000 x 1000 frame.
    Returns {(action, trial, serial): (poses2d, poses3d)}."""
    from h36x_torch.data.ingest import H36M_CAMERA_SERIALS, N_CAMS, N_SUBJECTS

    rng = np.random.default_rng(seed)
    ext = np.concatenate([rng.uniform(-np.pi, np.pi, (N_CAMS * N_SUBJECTS, 3)),
                          rng.normal(0, 2000, (N_CAMS * N_SUBJECTS, 3))], axis=1)
    intr = np.concatenate([rng.uniform(1140, 1150, (N_CAMS, 2)),
                           rng.uniform(490, 510, (N_CAMS, 2)),
                           rng.normal(0, 0.01, (N_CAMS, 5))], axis=1)
    w0 = " ".join(repr(float(v)) for v in np.concatenate([ext.ravel(), intr.ravel()]))
    rows = "".join(
        f"<tr><a>{a + 1}</a><b>{t}</b>"
        + "".join(f"<c{s}>Act{a} {t}</c{s}>" for s in range(1, N_SUBJECTS + 1)) + "</tr>"
        for a in range(1, 16) for t in (1, 2))
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "metadata.xml"), "w") as f:
        f.write(f"<root><w0>[{w0}]</w0><mapping>{rows}</mapping></root>")
    s, n = INGEST["subject"], INGEST["frames"]
    dirs = [os.path.join(root, f"S{s}", d) for d in (
        "Videos", "MyPoseFeatures/D2_Positions", "MyPoseFeatures/D3_Positions_mono")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    poses = {}
    for a in INGEST["actions"]:
        for t in INGEST["trials"]:
            for serial in H36M_CAMERA_SERIALS:
                seq = f"Act{a} {t}"
                centre = 500 + rng.uniform(-100, 100, 2)
                p2 = (centre + rng.uniform(-1, 1, (1, 32, 2)) * [100, 200]
                      + np.cumsum(rng.normal(0, 1, (n, 1, 2)), axis=0)).astype(np.float32)
                p3 = (300 * rng.normal(size=(n, 32, 3))).astype(np.float32)
                with open(os.path.join(dirs[0], f"{seq}.{serial}.mp4"), "wb") as f:
                    f.write(b"stub mp4")
                np.savez_compressed(os.path.join(dirs[1], f"{seq}.{serial}.npz"),
                                    Pose=p2.reshape(1, n, 64))
                np.savez_compressed(os.path.join(dirs[2], f"{seq}.{serial}.npz"),
                                    Pose=p3.reshape(1, n, 96))
                poses[(a, t, serial)] = (p2, p3)
    return poses


def tree_state(root) -> dict:
    """relative path -> (kind, mtime_ns, link target) of every entry."""
    out = {}
    for base, dirs, files in os.walk(root):
        for name in dirs + files:
            p = os.path.join(base, name)
            st = os.lstat(p)
            out[os.path.relpath(p, root)] = (
                st.st_mode >> 12, st.st_mtime_ns,
                os.readlink(p) if os.path.islink(p) else None)
    return out


def drive_ingest_path(tmp) -> str:
    """h36x_torch.cli.ingest.main over a raw tree this script writes: 16
    cells; each cell's gt_poses.pkl equal to the npz poses at
    H36M_RAW_JOINT_IDS, shapes (1000, 17, 2) and (1000, 17, 3);
    camera_wext.pkl's keys with rt orthonormal; the video a symlink to the
    raw mp4; a second run changes no file. Returns the ingested root."""
    import pickle

    from h36x_torch.cli.ingest import main as ingest_main
    from h36x_torch.data.ingest import ACTION_NAMES, H36M_CAMERA_SERIALS
    from h36x_torch.geometry.skeleton import H36M_RAW_JOINT_IDS

    raw, out = os.path.join(tmp, "raw"), os.path.join(tmp, "ingested")
    t0 = time.perf_counter()
    poses = write_raw_tree(raw)
    written = time.perf_counter() - t0
    t0 = time.perf_counter()
    cells = ingest_main(["--source-dir", raw, "--out-dir", out,
                         "--subjects", str(INGEST["subject"])])
    seconds = time.perf_counter() - t0
    ids = np.asarray(H36M_RAW_JOINT_IDS)
    s, n = INGEST["subject"], INGEST["frames"]
    checked = 0
    for (a, t, serial), (p2, p3) in poses.items():
        cam0 = H36M_CAMERA_SERIALS.index(serial)
        cdir = os.path.join(out, f"S{s}", f"{ACTION_NAMES[a - 1]}_{t - 1}", f"cam_{cam0}")
        with open(os.path.join(cdir, "gt_poses.pkl"), "rb") as f:
            gt = pickle.load(f)
        with open(os.path.join(cdir, "camera_wext.pkl"), "rb") as f:
            cam = pickle.load(f)
        video = os.path.join(cdir, f"S{s}_{ACTION_NAMES[a - 1]}_{t - 1}_cam_{cam0}.mp4")
        want_link = os.path.abspath(os.path.join(
            raw, f"S{s}", "Videos", f"Act{a} {t}.{serial}.mp4"))
        ok = (gt["2d"].shape == (n, 17, 2) and gt["3d"].shape == (n, 17, 3)
              and np.array_equal(gt["2d"], p2[:, ids]) and np.array_equal(gt["3d"], p3[:, ids])
              and set(cam) == {"f", "c", "k", "rt", "t"}
              and np.allclose(cam["rt"] @ cam["rt"].T, np.eye(3), atol=1e-12)
              and os.path.islink(video) and os.readlink(video) == want_link)
        if not ok:
            raise AssertionError(f"ingested cell {cdir} is wrong")
        checked += 1
    before = tree_state(out)
    t0 = time.perf_counter()
    again = ingest_main(["--source-dir", raw, "--out-dir", out,
                         "--subjects", str(INGEST["subject"])])
    second = time.perf_counter() - t0
    unchanged = tree_state(out) == before
    log({"phase": "ingest", "seconds": seconds, "raw_tree_seconds": written,
         "cells": cells, "cells_checked": checked, "second_run_seconds": second,
         "second_run_cells": again, "second_run_unchanged": unchanged,
         "entries": len(before)})
    if cells != 16 or checked != 16 or again != 16 or not unchanged:
        raise AssertionError(f"ingest: {cells} cells, {checked} checked, second run "
                             f"{again} cells, unchanged {unchanged}")
    return out


def check_crop_resize(dev, smi):
    """The device crop-resize front ends at H36M's traffic shape (one clip
    of 40 frames of 1000 x 1000 x 3 u8 on the card, cropped and resized to
    224): each form on cuda against the same call on the CPU and against
    the other (CROP_TOL), both against the native crop's u8 output
    (NATIVE_TOL; the gap is logged), resize_bilinear against itself on the
    CPU (CROP_TOL) and against F.interpolate on the card (INTERP_TOL); ms
    per clip of each form (CUDA events) beside the native crop's host
    ms."""
    from h36x_torch import native
    from h36x_torch.ops import preprocess as pre
    from h36x_torch.ops.resize import resize_bilinear

    c = CROP
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (c["frames"], c["raw"], c["raw"], 3), dtype=np.uint8)
    top, left, side, _ = c["box"]
    wy, wx = pre.crop_resize_matrices(c["box"], c["raw"], c["raw"], c["out"])
    gy, gx = pre.crop_resize_grids(c["box"], c["raw"], c["raw"], c["out"])
    host = torch.from_numpy(frames)
    on_card = host.to(dev)
    wy_d, wx_d = torch.from_numpy(wy).to(dev), torch.from_numpy(wx).to(dev)
    gy_d = tuple(torch.from_numpy(a).to(dev) for a in gy)
    gx_d = tuple(torch.from_numpy(a).to(dev) for a in gx)
    matrix = pre.fused_crop_resize(on_card, wy_d, wx_d)
    gather = pre.fused_crop_resize_gather(on_card, gy_d, gx_d)
    torch.cuda.synchronize()
    cpu_matrix = pre.fused_crop_resize(host, wy, wx)
    cpu_gather = pre.fused_crop_resize_gather(host, gy, gx)
    nat = torch.from_numpy(native.crop_resize_clip(frames, top, left, side, c["out"])
                           ).float() / 255.0
    errs = {
        "matrix_vs_cpu": float((matrix.cpu() - cpu_matrix).abs().max()),
        "gather_vs_cpu": float((gather.cpu() - cpu_gather).abs().max()),
        "matrix_vs_gather": float((matrix - gather).abs().max()),
        "matrix_vs_native": float((matrix.cpu() - nat).abs().max()),
        "gather_vs_native": float((gather.cpu() - nat).abs().max()),
    }
    img = (on_card.permute(0, 3, 1, 2).float() / 255.0).contiguous()
    resized = resize_bilinear(img, c["out"], c["out"])
    ref = torch.nn.functional.interpolate(img, size=(c["out"], c["out"]), mode="bilinear",
                                          align_corners=False, antialias=False)
    errs["resize_vs_cpu"] = float((resized.cpu() - resize_bilinear(
        img.cpu(), c["out"], c["out"])).abs().max())
    errs["resize_vs_interpolate"] = float((resized - ref).abs().max())
    ms = {"matrix_ms": time_ms(lambda: pre.fused_crop_resize(on_card, wy_d, wx_d), 10),
          "gather_ms": time_ms(lambda: pre.fused_crop_resize_gather(on_card, gy_d, gx_d), 10),
          "resize_bilinear_ms": time_ms(lambda: resize_bilinear(img, c["out"], c["out"]), 10),
          "interpolate_ms": time_ms(lambda: torch.nn.functional.interpolate(
              img, size=(c["out"], c["out"]), mode="bilinear", align_corners=False), 10),
          "native_host_ms": host_ms(lambda: native.crop_resize_clip(
              frames, top, left, side, c["out"]), 5)}
    shapes_ok = (matrix.shape == gather.shape == (c["frames"], c["out"], c["out"], 3)
                 and matrix.dtype == gather.dtype == torch.float32
                 and matrix.device.type == gather.device.type == dev.type)
    log({"phase": "crop_resize", "card": smi, "clip": [c["frames"], c["raw"], c["raw"], 3],
         "box": list(c["box"]), "out": c["out"], **errs, **ms, "tol": CROP_TOL,
         "native_tol": NATIVE_TOL, "interpolate_tol": INTERP_TOL, "per": "clip"})
    if not shapes_ok or max(errs["matrix_vs_cpu"], errs["gather_vs_cpu"],
                            errs["matrix_vs_gather"], errs["resize_vs_cpu"]) > CROP_TOL:
        raise AssertionError(f"crop-resize front ends: {errs}")
    if errs["resize_vs_interpolate"] > INTERP_TOL:
        raise AssertionError(f"resize_bilinear and F.interpolate on the card: {errs}")
    if max(errs["matrix_vs_native"], errs["gather_vs_native"]) > NATIVE_TOL:
        raise AssertionError(f"the native crop samples differently: {errs}")


class IngestedVideos:
    """The clips scan_clips finds in the ingested tree (subject 1, camera
    0, frame_skip 2), cut to the first EXTRACT["videos"] videos and to
    starts that fit in EXTRACT["frames"] subsampled frames, their poses and
    cameras those ingest wrote; the frames come from memory, u8 at H36M's
    raw size and made from a seed (the machine with the card has no OpenCV
    to decode the mp4s). The interface of h36x_torch.data.clips.ClipDataset
    that the unique-frame scheduler reads."""

    def __init__(self, root, seed=0):
        from h36x_torch.data.clips import ClipDataset

        e = EXTRACT
        base = ClipDataset(root, [INGEST["subject"]], seq_len=e["seq_len"],
                           stride=e["stride"], frame_skip=2, cams=[0])
        keep = sorted({c.video_idx for c in base.clips})[:e["videos"]]
        self.base = base
        self.clips = [c for c in base.clips
                      if c.video_idx in keep and c.end <= e["frames"]]
        rng = np.random.default_rng(seed)
        self.frames = {v: rng.integers(0, 256, (e["frames"], e["raw"], e["raw"], 3),
                                       dtype=np.uint8) for v in keep}

    def __len__(self):
        return len(self.clips)

    def clip_annotations(self, i):
        return self.base.clip_annotations(self.base.clips.index(self.clips[i]))

    def video_groups(self):
        groups = {}
        for i, ci in enumerate(self.clips):
            groups.setdefault(ci.video_idx, []).append(i)
        return [groups[v] for v in sorted(groups)]

    def video_joints2d(self, video_idx):
        return self.base.video_joints2d(video_idx)

    def open_video(self, video_idx):
        return SyntheticVideos.Cursor(self.frames[video_idx])

    def __getitem__(self, i):
        j3d, j2d, cam, ci = self.clip_annotations(i)
        return self.frames[ci.video_idx][ci.start:ci.end], j3d, j2d, cam, ci


def clip_rows(root) -> dict:
    """clip key (subject, action, cam, start) -> its rows of every array
    (the clip's variants), read from the store at `root`."""
    from h36x_torch.data.shards import load_index, read_shard, shard_path

    idx = load_index(root)
    shards_ = {}
    out = {}
    for c in idx["clips"]:
        sid = c["shard_id"]
        if sid not in shards_:
            shards_[sid] = read_shard(shard_path(root, sid), mmap=False)
        rows = slice(c["row"], c["row"] + idx["n_variants"])
        key = (c["subject"], c["action"], c["cam"], c["start"])
        if key in out:
            raise AssertionError(f"{root}: clip {key} twice")
        out[key] = {k: shards_[sid][k][rows] for k in ("feats", "joints3d", "joints2d", "K")}
    return out


def drive_partitioned_extract(dev, ingested, tmp, smi):
    """Partitioned extraction of the ingested tree's clips: run_extract
    (--engine opt) unpartitioned, as --partition 0/2 and as 1/2, each its
    own path with exact B5 counts; cli.merge_shards --verify --keep-parts
    unifies the parts; the merged store holds every clip of the
    unpartitioned run exactly once, joints and K equal, features within
    BACKBONE_REL_NORM (whether bit for bit is logged). Then a bf16 copy and
    a reference-format .pt copy of the merged store, each read back through
    FeatureClipDataset and one batch of it fed to the card in every
    --data.feed-dtype. Returns {path: launch counts}."""
    from h36x_torch.cli.merge_shards import main as merge_main
    from h36x_torch.data.features import FeatureClipDataset
    from h36x_torch.data.shards import (ShardWriter, as_tensor, bf16_bits, load_index,
                                        read_shard, shard_path, write_index)
    from h36x_torch.parallel.feed import FEED_DTYPES, to_device

    t0 = time.perf_counter()
    videos = IngestedVideos(ingested)
    log({"phase": "ingested_videos_made", "seconds": time.perf_counter() - t0,
         "clips": len(videos), "videos": len(videos.frames)})
    paths = {}
    runs = {}
    for name, part in (("full", ""), ("part0", "0/2"), ("part1", "1/2")):
        out = os.path.join(tmp, name)
        launches, summary = drive_extract_path(dev, videos, out, "opt", partition=part)
        paths[f"extract_partition_{name}"] = launches
        runs[name] = summary
    merged = os.path.join(tmp, "merged")
    t0 = time.perf_counter()
    idx = merge_main(["--parts", os.path.join(tmp, "part0"), os.path.join(tmp, "part1"),
                      "--out", merged, "--verify", "--keep-parts"])
    merge_s = time.perf_counter() - t0
    full, got = clip_rows(os.path.join(tmp, "full")), clip_rows(merged)
    same_keys = sorted(full) == sorted(got) and idx["n_clips"] == len(videos)
    diff2 = ref2 = 0.0
    exact_other = bit_for_bit = True
    for key, want in full.items():
        have = got.get(key)
        if have is None:
            continue
        exact_other &= all(np.array_equal(have[k], want[k]) for k in ("joints3d", "joints2d", "K"))
        bit_for_bit &= have["feats"].tobytes() == want["feats"].tobytes()
        a, b = torch.from_numpy(have["feats"]).double(), torch.from_numpy(want["feats"]).double()
        diff2 += float(((a - b) ** 2).sum())
        ref2 += float((b ** 2).sum())
    rel = (diff2 / ref2) ** 0.5 if ref2 > 0 else float("inf")
    log({"phase": "extract_partitioned", "card": smi,
         "clips_per_s": {k: r["clips_per_sec"] for k, r in runs.items()},
         "run_seconds": {k: r["seconds"] for k, r in runs.items()},
         "clips": {k: r["n_clips"] for k, r in runs.items()},
         "merge_seconds": merge_s, "merged_clips": idx["n_clips"],
         "merged_shards": idx["n_shards"], "same_clips_once": same_keys,
         "joints_K_equal": exact_other, "feats_rel_norm": rel,
         "feats_bit_for_bit": bit_for_bit, "tol_rel_norm": BACKBONE_REL_NORM})
    if not (same_keys and exact_other and rel <= BACKBONE_REL_NORM):
        raise AssertionError("the merged store differs from the unpartitioned run")

    # the bf16 copy and the reference's .pt copy of the merged store
    index = load_index(merged)
    bf16_root, pt_root = os.path.join(tmp, "bf16"), os.path.join(tmp, "pt")
    writer = ShardWriter(bf16_root, n_vars=index["n_variants"])
    os.makedirs(pt_root)
    for sid in range(index["n_shards"]):
        shard = read_shard(shard_path(merged, sid), mmap=False)
        arrays = {k: shard[k] for k in ("feats", "joints3d", "joints2d", "K")}
        writer.write({**arrays, "feats": torch.from_numpy(shard["feats"]).bfloat16()},
                     shard["meta"])
        torch.save({**{k: torch.from_numpy(v) for k, v in arrays.items()},
                    "meta": shard["meta"], "n_vars": shard["n_vars"]},
                   os.path.join(pt_root, f"shard_{sid:05d}.pt"))
    write_index(bf16_root, index["clips"], **{k: index[k] for k in (
        "n_shards", "n_clips", "n_variants", "aug_names", "seq_len", "frame_skip",
        "shuffle_seed", "shuffle_pool")}, feat_dtype="bfloat16")
    torch.save({k: index[k] for k in ("clips", "n_shards", "n_clips", "n_variants",
                                      "aug_names", "seq_len", "frame_skip", "feat_dtype")},
               os.path.join(pt_root, "index.pt"))
    rows = list(range(0, 4 * index["n_variants"], 3))
    want = FeatureClipDataset(merged, augment=True).get_batch(rows)
    forms = {}
    for name, root in (("bf16", bf16_root), ("pt", pt_root)):
        ds = FeatureClipDataset(root, augment=True)
        batch = ds.get_batch(rows)
        want_feats = (bf16_bits(torch.from_numpy(want[0]).bfloat16()) if name == "bf16"
                      else want[0])
        same = (batch[0].tobytes() == want_feats.tobytes()
                and all(np.array_equal(a, b) for a, b in zip(batch[1:], want[1:])))
        fed = {}
        for feed, dtype in FEED_DTYPES.items():
            on_card = to_device(batch, dev, dtype)
            fed[feed] = (on_card[0].dtype == dtype and on_card[0].device.type == dev.type
                         and torch.equal(on_card[0].cpu(), as_tensor(batch[0]).to(dtype)))
        forms[name] = {"torch_format": ds.torch_format, "batch_equal": same, "fed": fed}
        if not (same and all(fed.values())):
            raise AssertionError(f"{name} copy of the store: {forms[name]}")
    log({"check": "store forms", **forms})
    return paths


def split_update(parts: int):
    """TrainStep._update of a one-process control run: the fused step's
    gradients (and metrics) of each of `parts` equal row blocks of the
    batch taken separately, averaged as mean_across_processes averages
    those of `parts` processes (one flat float32 buffer per block, the
    blocks summed in rank order, divided by `parts`), then AdamW."""

    def update(self, batch, generator=None):
        rows = batch[0].shape[0] // parts
        flats = []
        for r in range(parts):
            metrics = self.grads_fn(tuple(b[r * rows:(r + 1) * rows] for b in batch),
                                    generator)
            for p in self.trainable:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            tensors = [p.grad for p in self.trainable] + list(metrics.values())
            flats.append(torch.cat([t.detach().reshape(-1).float() for t in tensors]))
        flat = flats[0]
        for f in flats[1:]:
            flat = flat + f
        flat.div_(parts)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        self.optimizer.step()
        return metrics

    return update


def train_worker(report, argv, split: int = 1) -> int:
    """One process of a data-parallel cli.train run (chip_smoke.py
    --train-worker REPORT ARGS...): the counts set to 0, cli.train.main
    (ARGS), then REPORT gets this process's launch counts, each epoch's
    train timing (fit's train_epoch, recorded), and each train step's loss
    and ms (host clock between two synchronisations: the step, its
    all-reduce and any wait for the other rank). `split` > 1 (chip_smoke.py
    --control-worker REPORT ARGS...: 2) makes every update the one-process
    control's :func:`split_update`."""
    from h36x_torch.cli.train import main as train_main
    from h36x_torch.train import loop
    from h36x_torch.train.step import TrainStep

    if split > 1:
        TrainStep._update = split_update(split)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timing = []
    inner = loop.train_epoch

    def recorded(*args, **kwargs):
        out = inner(*args, **kwargs)
        timing.append(out["_timing"])
        return out

    loop.train_epoch = recorded
    step_ms, losses = [], []
    call = TrainStep.__call__

    def timed(self, *args, **kwargs):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(self, *args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(out["loss"].tolist())
        return out

    TrainStep.__call__ = timed
    zero_counts()
    train_main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with open(report, "w") as f:
        json.dump({"launches": read_counts(), "timing": timing, "step_ms": step_ms,
                   "losses": losses}, f)
    return 0


def run_ranks(argvs, logs_dir, timeout=600) -> list:
    """Start one process per argv, wait for all (each under `timeout`),
    kill any left; returns their (returncode, output tail)."""
    procs, outs = [], []
    try:
        for i, argv in enumerate(argvs):
            out = open(os.path.join(logs_dir, f"rank{i}_{len(os.listdir(logs_dir))}.log"), "w+")
            outs.append(out)
            procs.append(subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    result = []
    for p, out in zip(procs, outs):
        out.seek(0)
        result.append((p.returncode, out.read()[-3000:]))
        out.close()
    return result


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def max_param_diff(path_a, path_b) -> float:
    """max |a - b| over the params of two msgpack checkpoints (inf when
    their keys or a leaf's shape differ)."""
    from h36x_torch.train.checkpoint import load_params_raw

    def leaves(tree, path=""):
        for k, v in tree.items():
            yield from (leaves(v, f"{path}{k}.") if isinstance(v, dict) else [(path + k, v)])

    a = dict(leaves(load_params_raw(path_a)))
    b = dict(leaves(load_params_raw(path_b)))
    if a.keys() != b.keys():
        return float("inf")
    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
               if a[k].shape == b[k].shape else float("inf") for k in a)


def check_split_control(ranks, rank0, rows, dist_dir, single, want, smi):
    """The control of the 2-process rows: one process, the same store, init
    and flags, each update made from the fused step's gradients of rows
    0-15 and 16-31 taken separately and averaged as the 2 processes'
    all-reduce averages them (:func:`split_update`). Logged per step beside
    the 2-process run and the one-process run; the control must equal the
    2-process run within CONTROL_TOL per step (whether bit for bit is
    logged), and its params (last.msgpack) are compared with rank 0's."""
    _, (control,), seconds, control_dirs = ranks("dist_control", 1,
                                                 worker="--control-worker")
    control_rows = read_rows(control_dirs[0])
    vs_dist = [abs(a - b) / abs(b) for a, b in zip(control["losses"], rank0["losses"])]
    vs_single = [abs(a - b) / abs(b) for a, b in zip(control["losses"], single["losses"])]
    record = {
        "phase": "train_dist_control", "card": smi, "seconds": seconds,
        "control": "one process, each update from the gradients of rows 0-15 and "
                   "16-31 taken separately, summed in float32 and halved",
        "losses": {"control": control["losses"], "two_processes": rank0["losses"],
                   "one_process": single["losses"]},
        "step_rel_diff_vs_two_processes": vs_dist,
        "step_rel_diff_vs_one_process": vs_single,
        "bit_for_bit_vs_two_processes": control["losses"] == rank0["losses"],
        "rows_rel_diff_vs_two_processes": {
            k: max(abs(r[k] - w[k]) / abs(w[k]) for r, w in zip(control_rows, rows))
            for k in ROW_KEYS},
        "max_param_diff_vs_two_processes": max_param_diff(
            os.path.join(control_dirs[0], "last.msgpack"),
            os.path.join(dist_dir, "last.msgpack")),
        "max_param_diff_vs_one_process": max_param_diff(
            os.path.join(control_dirs[0], "last.msgpack"),
            os.path.join(os.path.dirname(dist_dir), "dist_single", "last.msgpack")),
        "launches": control["launches"], "tol": CONTROL_TOL}
    log(record)
    # the control's kernels run on 16-row blocks: twice the fused launches
    # of the train steps, the eval's as one process's
    if control["launches"]["gn_relu_cconv_bwd"] != 2 * want["gn_relu_cconv_bwd"]:
        raise AssertionError(f"control launches {control['launches']}")
    if len(vs_dist) != len(rank0["losses"]) or max(vs_dist) > CONTROL_TOL:
        raise AssertionError(f"the split-gradient control differs from the 2-process "
                             f"run: {vs_dist}")
    return control["launches"]


def train_ranks(tmp, name, n, *flags, collectives="gloo", outdirs=None,
                worker="--train-worker"):
    """cli.train over drive_train_path's store (tmp/store) in n worker
    processes (this script as `worker` REPORT ARGS; n > 1: --dist.*, each
    rank its own --outdir); returns (their (rc, output tail)s, reports,
    seconds, outdirs)."""
    store = os.path.join(tmp, "store")
    logs_dir = os.path.join(tmp, "dist_logs")
    os.makedirs(logs_dir, exist_ok=True)
    port = free_port()
    outdirs = outdirs or [os.path.join(tmp, name if i == 0 else f"{name}_rank{i}")
                          for i in range(n)]
    reports = [os.path.join(tmp, f"{name}_report{i}_{time.time_ns()}.json")
               for i in range(n)]
    dist = []
    if n > 1:
        dist = ["--dist.num-processes", str(n), "--dist.coordinator", f"localhost:{port}"]
        if collectives:
            dist += ["--dist.collectives", collectives]
    argvs = [[sys.executable, os.path.abspath(__file__), worker, reports[i],
              *train_argv(store, outdirs[i], *flags, *dist,
                          *(["--dist.process-id", str(i)] if n > 1 else []))]
             for i in range(n)]
    t0 = time.perf_counter()
    result = run_ranks(argvs, logs_dir)
    seconds = time.perf_counter() - t0
    got = []
    for (rc, out), report in zip(result, reports):
        if rc != 0 and collectives:
            raise AssertionError(f"{name}: a rank failed (rc {rc}):\n{out}")
        if rc == 0:
            with open(report) as f:
                got.append(json.load(f))
    return result, got, seconds, outdirs


def drive_dist_train_path(tmp, base_rows, smi):
    """Two processes on the one card (--dist.num-processes 2, gloo through
    the host, 16 rows each) train like drive_train_path's single-process
    fused run (its store, flags and rows): each rank's first step loss
    equals a one-process worker's at LOSS_TOL and every later one at
    DIST_ROW_TOL, rank 0's metrics.jsonl equals the single-process rows at
    DIST_ROW_TOL on DIST_ROW_KEYS, rank 1 writes no file (its --outdir is its
    own, and must stay absent), each process launches B1-B4 exactly as the
    single-process run; step ms per process beside the single process's.
    Then the same 2-process run stopped after 1 epoch and resumed by a
    fresh pair: rows equal the straight run's. And NCCL, the default on
    CUDA, must refuse two ranks on one card with a clear error. Returns
    {path: launch counts} (each rank its own path)."""
    import math

    steps = TRAIN["train_clips"] // TRAIN["batch"]
    evals = math.ceil(TRAIN["val_clips"] / TRAIN["batch"])
    epochs = TRAIN["epochs"]
    want = expect_counts(gn_relu_cconv=4 * epochs * (steps + evals),
                         gn_relu_cconv_bwd=4 * epochs * steps,
                         joint_regressor=epochs * (steps + evals),
                         joint_regressor_bwd=epochs * steps)

    ranks = functools.partial(train_ranks, tmp)

    def median(xs):
        return float(np.median(xs)) if xs else float("nan")

    _, (single,), _, single_dirs = ranks("dist_single", 1)
    single_rows = read_rows(single_dirs[0])
    _, reports, seconds, outdirs = ranks("dist", 2)
    rows = read_rows(outdirs[0])
    max_rel = max(abs(r[k] - w[k]) / abs(w[k]) for r, w in zip(rows, base_rows)
                  for k in DIST_ROW_KEYS)
    step_rel = [[abs(a - b) / abs(b) for a, b in zip(r["losses"], single["losses"])]
                for r in reports]
    log({"phase": "train_dist", "card": smi, "processes": 2,
         "collectives": "gloo through the host (two ranks share one card; not NCCL)",
         "seconds": seconds, "launches_per_rank": [r["launches"] for r in reports],
         "step_ms_median_per_rank": [median(r["step_ms"][steps:]) for r in reports],
         "step_ms_per_rank": [r["step_ms"] for r in reports],
         "single_process_step_ms_median": median(single["step_ms"][steps:]),
         "single_process_step_ms": single["step_ms"],
         "step_ms_is": "host clock between synchronisations around each train step "
                       "(medians over epoch 2)",
         "single_worker_rows_equal_in_process_rows": len(single_rows) == len(base_rows)
         and all(r[k] == w[k] for r, w in zip(single_rows, base_rows) for k in ROW_KEYS),
         "step_loss_rel_diff_per_rank": step_rel, "first_step_tol": LOSS_TOL["rtol"],
         "max_rel_diff_vs_single": max_rel, "rel_diff_by_key": {
             k: max(abs(r[k] - w[k]) / abs(w[k]) for r, w in zip(rows, base_rows))
             for k in ROW_KEYS}, "tol": DIST_ROW_TOL, "metrics": rows,
         "rank1_outdir_exists": os.path.exists(outdirs[1])})
    if any(r["launches"] != want for r in reports + [single]):
        raise AssertionError(f"2-process launches {[r['launches'] for r in reports]} != {want}")
    if os.path.exists(outdirs[1]):
        raise AssertionError("rank 1 wrote files")
    if any(len(d) != epochs * steps or d[0] > LOSS_TOL["rtol"] or max(d) > DIST_ROW_TOL
           for d in step_rel):
        raise AssertionError(f"2-process step losses differ from one process's: {step_rel}")
    if len(rows) != len(base_rows) or max_rel > DIST_ROW_TOL:
        raise AssertionError(f"2-process rows differ from the single process's: {max_rel}")
    control = check_split_control(ranks, reports[0], rows, outdirs[0], single, want, smi)
    paths = {"train_dist_single": single["launches"],
             "train_dist_rank0": reports[0]["launches"],
             "train_dist_rank1": reports[1]["launches"],
             "train_dist_control": control}

    cut = os.path.join(tmp, "dist_resume")
    _, first, s1, _ = ranks("dist_resume", 2, "--optim.stop-after-epochs", "1",
                            outdirs=[cut, cut + "_rank1"])
    _, second, s2, _ = ranks("dist_resume", 2, "--resume", cut, outdirs=[cut, cut + "_rank1"])
    resumed = [{k: r[k] for k in ("epoch", *ROW_KEYS)} for r in read_rows(cut)]
    straight = [{k: r[k] for k in ("epoch", *ROW_KEYS)} for r in rows]
    legs = [{k: a["launches"][k] + b["launches"][k] for k in a["launches"]}
            for a, b in zip(first, second)]
    log({"phase": "train_dist_resume", "seconds": s1 + s2, "launches_per_rank": legs,
         "metrics": resumed, "equal": resumed == straight})
    if resumed != straight or any(c != want for c in legs) or os.path.exists(cut + "_rank1"):
        raise AssertionError("2-process stop + --resume differs from the straight run")
    paths.update({"train_dist_resume_rank0": legs[0], "train_dist_resume_rank1": legs[1]})

    result, _, secs, _ = ranks("dist_nccl", 2, "--optim.epochs", "1", collectives="")
    refused = [rc != 0 and "NCCL refuses two ranks on one device" in out
               for rc, out in result]
    log({"check": "nccl two ranks on one card", "refused": refused, "seconds": secs})
    if not all(refused):
        raise AssertionError(f"NCCL with two ranks on one card was not refused: {result}")
    return paths


def recorded_cfg(ref):
    """A TrainConfig whose model section is the one the manifest of
    checkpoint `ref` (`outdir/last`) records."""
    from h36x_torch.config import TrainConfig
    from h36x_torch.train import checkpoint as ckpt

    cfg = TrainConfig()
    cfg.model = dataclasses.replace(cfg.model,
                                    **ckpt.load_recorded_config(ref)["model"])
    return cfg


def state_of(outdir, name):
    """(model, optimizer, manifest) of checkpoint `name` under `outdir`
    (either backend), restored into a CPU model of the recorded config by
    load_checkpoint."""
    from h36x_torch.train import checkpoint as ckpt
    from h36x_torch.train.loop import build_model
    from h36x_torch.train.state import make_optimizer

    cfg = recorded_cfg(os.path.join(outdir, name))
    model = build_model(cfg, "cpu")
    opt, _ = make_optimizer(model, cfg.optim.lr, cfg.optim.weight_decay)
    manifest = ckpt.load_checkpoint(outdir, name, model, opt)
    return model, opt, manifest


def states_equal(a, b) -> bool:
    """Params, AdamW's mu, nu, count and hyper-parameters, and the step of
    two state_of() results, bit for bit."""
    from h36x_torch.train.state import optimizer_tensors

    (ma, oa, fa), (mb, ob, fb) = a, b
    return (fa["step"] == fb["step"]
            and all(torch.equal(x, y) for x, y in zip(ma.state_dict().values(),
                                                      mb.state_dict().values()))
            and all(torch.equal(x, y) for x, y in zip(optimizer_tensors(oa),
                                                      optimizer_tensors(ob))))


def time_checkpoints(tmp, dev, smi) -> dict:
    """Save and load seconds of the flagship training state (the trained
    phase-1 model of tmp/runs, on the card) with both backends, and the
    zstd decoder's rate on the orbax store's chunk frames (raw blocks) and
    on the golden directory's (compressed blocks, Huffman and FSE)."""
    from h36x_torch.train import checkpoint as ckpt
    from h36x_torch.train.loop import build_model
    from h36x_torch.train.state import make_optimizer
    from h36x_torch.utils import ocdbt, zstd

    model, opt, _ = state_of(os.path.join(tmp, "runs"), "last")
    model.to(dev)
    opt_dev, _ = make_optimizer(model, 1e-4)
    for p, q in zip(opt.param_groups[0]["params"], opt_dev.param_groups[0]["params"]):
        for key in ("mu", "nu"):
            opt_dev.state[q][key].copy_(opt.state[p][key])
    out = os.path.join(tmp, "ckpt_timing")
    rec = {"phase": "checkpoint_timing", "card": smi}
    for backend, save in (("msgpack", ckpt.save_checkpoint),
                          ("orbax", ckpt.save_checkpoint_orbax)):
        d = os.path.join(out, backend)
        t0 = time.perf_counter()
        save(d, "last", model, opt_dev, 0, 1.0, 8)
        rec[f"{backend}_save_s"] = time.perf_counter() - t0
        again = build_model(recorded_cfg(os.path.join(tmp, "runs", "last")), "cpu")
        aopt, _ = make_optimizer(again, 1e-4)
        t0 = time.perf_counter()
        ckpt.load_checkpoint(d, "last", again, aopt)
        rec[f"{backend}_load_s"] = time.perf_counter() - t0
    slot = os.path.join(out, "orbax", "last.0")
    rec["orbax_bytes_on_disk"] = sum(os.path.getsize(os.path.join(r, f))
                                     for r, _, fs in os.walk(slot) for f in fs)
    for what, root, reps in (("raw_blocks", slot, 1),
                             ("compressed_blocks", os.path.join(
                                 os.path.dirname(os.path.abspath(__file__)), "tests",
                                 "golden", "orbax_v1", "last.0"), 20)):
        frames = [v for k, v in ocdbt.Store(root).read_all().items()
                  if not k.endswith(b".zarray")]
        t0 = time.perf_counter()
        n = sum(len(zstd.decompress(f)) for _ in range(reps) for f in frames)
        rec[f"zstd_{what}_MB_per_s"] = n / 1e6 / (time.perf_counter() - t0)
        rec[f"zstd_{what}_MB"] = n / 1e6 / reps
    rec["zstd_is"] = ("host decode of every chunk frame, the port's C++ decoder "
                      "(h36x_torch/native/zstd.cpp), one thread")
    log(rec)
    return rec


def drive_orbax_tp_path(dev, g, tmp, base_rows, smi):
    """Orbax checkpoints and tensor parallelism at the flagship width, on
    drive_train_path's store and flags (tmp/store, tmp/runs).

    1. One process, fused, --ckpt-backend orbax (in this process, counted):
       B1-B4 launched as drive_train_path's run, rows equal base_rows bit
       for bit, and its `last` (load_checkpoint of the orbax directory)
       equal to the msgpack run's `last`: params, mu, nu, count, the
       hyper-parameters and step. A run stopped after epoch 1 and
       --resume'd from orbax equals the straight run. Save and load
       seconds of the flagship state by backend, and the decoder's MB/s.
    2. Tensor parallelism: 2 processes on the one card over gloo (NCCL
       refuses two ranks on one card), --mesh.model 2 --ckpt-backend orbax,
       the plain step (h36x refuses the fused one), dropout 0, against the
       one-process plain run on the same store and init: every step's loss
       (the first at LOSS_TOL, the rest at DIST_ROW_TOL) and the rows on
       DIST_ROW_KEYS at DIST_ROW_TOL; rank 1 writes nothing; a pair
       --resume'd from the TP run's orbax `last` (stopped after epoch 1)
       equals the straight TP run. ms per step per rank (host clock) and
       the bytes each step all-gathers.
    3. One process serves the TP run's orbax `best` through
       infer.make_fused_forward(precise=True): 4 B1 + 1 B3 a call, within
       E2E_TOL of the plain engine of the same params; cli.convert
       --to-torch-ckpt of the orbax directory gives the bytes of a msgpack
       save of the same params.
    4. The golden orbax directory h36x wrote (tests/golden/orbax_v1) read
       by the port equals tests/golden/orbax_v1.npz bit for bit: the C++
       decoder's compressed-block path on this host.
    Returns {path: launch counts}."""
    import math

    from h36x_torch.cli import convert
    from h36x_torch.cli.train import main as train_main
    from h36x_torch.infer import make_fused_forward
    from h36x_torch.models.phd import param_tree
    from h36x_torch.train import checkpoint as ckpt
    from h36x_torch.train.loop import build_model

    store = os.path.join(tmp, "store")
    epochs, batch = TRAIN["epochs"], TRAIN["batch"]
    steps = TRAIN["train_clips"] // batch
    evals = math.ceil(TRAIN["val_clips"] / batch)
    want = expect_counts(gn_relu_cconv=4 * epochs * (steps + evals),
                         gn_relu_cconv_bwd=4 * epochs * steps,
                         joint_regressor=epochs * (steps + evals),
                         joint_regressor_bwd=epochs * steps)
    paths = {}

    # 1. orbax, one process, fused
    orbax_dir = os.path.join(tmp, "orbax")
    zero_counts()
    t0 = time.perf_counter()
    train_main(train_argv(store, orbax_dir, "--ckpt-backend", "orbax"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    rows = read_rows(orbax_dir)
    straight = [{k: r[k] for k in ("epoch", *ROW_KEYS)} for r in rows]
    base = [{k: r[k] for k in ("epoch", *ROW_KEYS)} for r in base_rows]
    same_last = states_equal(state_of(orbax_dir, "last"),
                             state_of(os.path.join(tmp, "runs"), "last"))
    listing = sorted(os.listdir(orbax_dir))
    log({"phase": "train_orbax", "seconds": seconds, "launches": launches,
         "rows_equal_msgpack_run": straight == base, "last_equal_msgpack_last": same_last,
         "files": listing, "ckpt_save_s": [r["ckpt_save_s"] for r in rows]})
    if launches != want or straight != base or not same_last:
        raise AssertionError("the orbax run differs from the msgpack run")
    if not {"best.json", "last.json"} <= set(listing) or any(
            n.endswith(".msgpack") for n in listing):
        raise AssertionError(f"orbax run wrote {listing}")
    paths["train_orbax"] = launches
    cut = os.path.join(tmp, "orbax_resume")
    zero_counts()
    train_main(train_argv(store, cut, "--ckpt-backend", "orbax",
                          "--optim.stop-after-epochs", "1"))
    train_main(train_argv(store, cut, "--ckpt-backend", "orbax", "--resume", cut))
    torch.cuda.synchronize()
    legs = read_counts()
    resumed = [{k: r[k] for k in ("epoch", *ROW_KEYS)} for r in read_rows(cut)]
    same_last = states_equal(state_of(cut, "last"), state_of(orbax_dir, "last"))
    log({"phase": "train_orbax_resume", "launches": legs, "rows_equal": resumed == straight,
         "last_equal": same_last})
    if legs != want or resumed != straight or not same_last:
        raise AssertionError("orbax stop + --resume differs from the straight run")
    paths["train_orbax_resume"] = legs
    time_checkpoints(tmp, dev, smi)

    # 2. tensor parallelism over 2 processes on the one card
    plain = ("--optim.fused", "false", "--ckpt-backend", "orbax")
    ranks = functools.partial(train_ranks, tmp)
    _, (single,), s_single, single_dirs = ranks("tp_single", 1, *plain)
    single_rows = read_rows(single_dirs[0])
    _, reports, s_tp, tp_dirs = ranks("tp", 2, *plain, "--mesh.model", "2")
    tp_rows = read_rows(tp_dirs[0])
    step_rel = [[abs(a - b) / abs(b) for a, b in zip(r["losses"], single["losses"])]
                for r in reports]
    row_rel = {k: max(abs(r[k] - w[k]) / abs(w[k]) for r, w in zip(tp_rows, single_rows))
               for k in ROW_KEYS}

    def median(xs):
        return float(np.median(xs)) if xs else float("nan")

    gather_bytes = [r["tp_train_all_gather_bytes"] / (r["eager_steps"] or 1)
                    for r in tp_rows]
    reduce_bytes = [r["tp_train_all_reduce_bytes"] / (r["eager_steps"] or 1)
                    for r in tp_rows]
    log({"phase": "train_tp", "card": smi, "processes": 2, "mesh": "data 1 x model 2",
         "collectives": "gloo through the host (two ranks share one card)",
         "seconds": s_tp, "single_seconds": s_single,
         "launches_per_rank": [r["launches"] for r in reports],
         "step_ms_median_per_rank": [median(r["step_ms"][steps:]) for r in reports],
         "step_ms_per_rank": [r["step_ms"] for r in reports],
         "single_process_step_ms_median": median(single["step_ms"][steps:]),
         "step_ms_is": "host clock between synchronisations around each train step "
                       "(medians over epoch 2); the plain step, both runs",
         "all_gather_bytes_per_step": gather_bytes,
         "all_reduce_bytes_per_step": reduce_bytes,
         "step_loss_rel_diff_per_rank": step_rel, "first_step_tol": LOSS_TOL["rtol"],
         "rel_diff_by_key": row_rel, "tol": DIST_ROW_TOL, "metrics": tp_rows,
         "rank1_outdir_exists": os.path.exists(tp_dirs[1])})
    if any(r["launches"] != expect_counts() for r in reports + [single]):
        raise AssertionError("the plain step launched a kernel")
    if os.path.exists(tp_dirs[1]):
        raise AssertionError("rank 1 wrote files")
    if any(len(d) != epochs * steps or d[0] > LOSS_TOL["rtol"] or max(d) > DIST_ROW_TOL
           for d in step_rel):
        raise AssertionError(f"TP step losses differ from one process's: {step_rel}")
    if len(tp_rows) != len(single_rows) or max(row_rel[k] for k in DIST_ROW_KEYS) > DIST_ROW_TOL:
        raise AssertionError(f"TP rows differ from one process's: {row_rel}")
    paths.update({"train_tp_single": single["launches"],
                  "train_tp_rank0": reports[0]["launches"],
                  "train_tp_rank1": reports[1]["launches"]})
    cut = os.path.join(tmp, "tp_resume")
    _, first, s1, _ = ranks("tp_resume", 2, *plain, "--mesh.model", "2",
                            "--optim.stop-after-epochs", "1", outdirs=[cut, cut + "_rank1"])
    _, second, s2, _ = ranks("tp_resume", 2, *plain, "--mesh.model", "2", "--resume", cut,
                             outdirs=[cut, cut + "_rank1"])
    resumed = [{k: r[k] for k in ("epoch", *ROW_KEYS)} for r in read_rows(cut)]
    tp_straight = [{k: r[k] for k in ("epoch", *ROW_KEYS)} for r in tp_rows]
    same_last = states_equal(state_of(cut, "last"), state_of(tp_dirs[0], "last"))
    log({"phase": "train_tp_resume", "seconds": s1 + s2, "rows_equal": resumed == tp_straight,
         "last_equal": same_last})
    if resumed != tp_straight or not same_last or os.path.exists(cut + "_rank1"):
        raise AssertionError("TP stop + --resume differs from the straight TP run")

    # 3. serve the TP run's orbax best
    cfg = recorded_cfg(os.path.join(tmp, "runs", "last"))
    model = build_model(cfg, dev)
    best = os.path.join(tp_dirs[0], "best")
    model.load_state_dict(ckpt.load_params_only(best, model.state_dict()))
    feats = torch.randn(batch, 40, cfg.model.feature_dim, generator=g).to(dev)
    kw = dict(joints_num=model.joints_num, groups=model.groups,
              regressor_iters=model.regressor_iters, precise=True)
    fused = make_fused_forward(param_tree(model), **kw)
    zero_counts()
    got = fused(feats)
    torch.cuda.synchronize()
    served = read_counts()
    want_plain = make_fused_forward(param_tree(model), use_kernels=False, **kw)(feats)
    err = compare("serve the TP run's orbax best", got, want_plain, E2E_TOL)
    if served != expect_counts(gn_relu_cconv=4, joint_regressor=1):
        raise AssertionError(f"serving launches {served}")
    paths["serve_tp_orbax"] = served
    msg_dir = os.path.join(tmp, "tp_best_msgpack")
    ckpt.save_params(msg_dir, "best", {k: v.cpu() for k, v in model.state_dict().items()})
    outs = []
    for ref in (best, os.path.join(msg_dir, "best.msgpack")):
        out = os.path.join(tmp, f"sd_{len(outs)}", "best.pt")  # zip records carry the name
        convert.main(["--to-torch-ckpt", ref, "--out", out])
        with open(out, "rb") as f:
            outs.append(f.read())
    log({"phase": "serve_tp_orbax", "launches": served, "against_plain": err,
         "convert_equal": outs[0] == outs[1]})
    if outs[0] != outs[1]:
        raise AssertionError("cli.convert of the orbax best differs from the msgpack one")

    # 4. the golden orbax directory h36x wrote
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")
    from h36x_torch.utils import zarr_lite

    tree = zarr_lite.read_tree(os.path.join(golden, "orbax_v1", "last.0"))
    want_npz = np.load(os.path.join(golden, "orbax_v1.npz"))

    def leaf(path):
        node = tree
        for k in path.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        return node

    bad = [k for k in want_npz.files
           if not (leaf(k).dtype == want_npz[k].dtype and np.array_equal(leaf(k), want_npz[k]))]
    log({"phase": "golden_orbax", "arrays": len(want_npz.files), "bit_for_bit": not bad})
    if bad:
        raise AssertionError(f"golden orbax arrays differ: {bad[:5]}")
    return paths


# The tools phase (drive_tools_path): parity's verdict is BASELINE.json's
# 0.1 mm on the predictions, and its control shifts one joint by 0.5 mm
PARITY_TOL_MM = 0.1
PARITY_SHIFT_M = 0.5e-3


class TorchCausalConv1d(torch.nn.Module):
    """The reference PHD's causal conv: replicate left pad, Conv1d."""

    def __init__(self, channels, kernel_size=3):
        super().__init__()
        self.left_pad = kernel_size - 1
        self.conv = torch.nn.Conv1d(channels, channels, kernel_size, padding=0)

    def forward(self, x):  # (B, C, T)
        x = torch.nn.functional.pad(x, (self.left_pad, 0), mode="replicate")
        return self.conv(x)


class TorchResidualBlock(torch.nn.Module):
    def __init__(self, channels, groups=32):
        super().__init__()
        self.gn1 = torch.nn.GroupNorm(groups, channels)
        self.conv1 = TorchCausalConv1d(channels)
        self.gn2 = torch.nn.GroupNorm(groups, channels)
        self.conv2 = TorchCausalConv1d(channels)

    def forward(self, x):
        r = x
        x = self.conv1(torch.relu(self.gn1(x)))
        x = self.conv2(torch.relu(self.gn2(x)))
        return x + r


class TorchCausalTemporalNet(torch.nn.Module):
    def __init__(self, latent, num_blocks):
        super().__init__()
        self.blocks = torch.nn.Sequential(
            *[TorchResidualBlock(latent) for _ in range(num_blocks)])

    def forward(self, x):  # (B, T, D)
        return self.blocks(x.permute(0, 2, 1)).permute(0, 2, 1)


class TorchJointRegressor(torch.nn.Module):
    def __init__(self, latent, joints=17, iters=3, hidden=1024):
        super().__init__()
        self.iters = iters
        self.joints = joints
        out = joints * 3
        self.mlp = torch.nn.Sequential(
            torch.nn.Linear(latent + out, hidden), torch.nn.ReLU(),
            torch.nn.Linear(hidden, hidden), torch.nn.ReLU(),
            torch.nn.Linear(hidden, out),
        )
        self.register_buffer("y0", torch.zeros(out))

    def forward(self, phi):
        b, t, _ = phi.shape
        y = self.y0.view(1, 1, -1).expand(b, t, -1).contiguous()
        for _ in range(self.iters):
            y = y + self.mlp(torch.cat([phi, y], dim=-1))
        return y.view(b, t, self.joints, 3)


class TorchPHD(torch.nn.Module):
    """A torch copy of the reference's PHD model (the module of
    tests/test_trajectory_parity.py; dropout left out, as in eval), at the
    flagship width by default."""

    def __init__(self, latent=1024, feature=2048, number_blocks=2, ar_blocks=3):
        super().__init__()
        self.f_movie = TorchCausalTemporalNet(latent, number_blocks)
        self.f_AR = TorchCausalTemporalNet(latent, ar_blocks)
        self.f_3D = TorchJointRegressor(latent)
        self.input_proj = torch.nn.Linear(feature, latent)

    def forward(self, feats):
        return self.f_3D(self.f_movie(self.input_proj(feats)))


def to_reference_keys(sd) -> dict:
    """TorchPHD's state_dict under the reference's keys: its regressor
    Sequential holds a Dropout after the first ReLU, so the Linear layers
    sit at indices 0, 3, 5 there (0, 2, 4 here)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("f_3D.mlp."):
            parts = k.split(".")
            parts[2] = {"0": "0", "2": "3", "4": "5"}[parts[2]]
            k = ".".join(parts)
        out[k] = v.detach().cpu().clone()
    return out


def run_cli(fn, argv, expect_exit=0):
    """fn(argv) with its standard output captured (and logged): (output,
    seconds). Raises unless it exits with `expect_exit` (0: returns, or
    SystemExit(0))."""
    import contextlib
    import io

    buf = io.StringIO()
    code = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        try:
            fn(argv)
        except SystemExit as e:  # a message exits 1, as the interpreter does
            if isinstance(e.code, str):
                print(e.code)
            code = e.code if isinstance(e.code, int) else int(e.code is not None)
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    log({"cli": getattr(fn, "__module__", str(fn)), "argv": [str(a) for a in argv],
         "exit": code, "seconds": seconds, "output": out.splitlines()})
    if code != expect_exit:
        raise AssertionError(f"{fn.__module__} {argv}: exit {code}, not {expect_exit}")
    return out, seconds


def parity_delta_mm(out: str) -> float:
    import re

    m = re.search(r"prediction delta: ([0-9.]+) mm", out)
    if m is None:
        raise AssertionError(f"parity printed no prediction delta:\n{out}")
    return float(m.group(1))


def drive_tools_path(dev, g, tmp, card, ingested, artifact):
    """The tools at full width (the flagship ModelConfig, T 40; TF32 off):

    - a reference PHD checkpoint: TorchPHD from a seed, saved as
      {"model": state_dict} under the reference's keys, and a reference NPZ
      of 32 x 40 x 2048 seeded features with its float32 predictions on
      the card;
    - cli.convert --torch-ckpt to a msgpack checkpoint, --to-torch-ckpt
      back: the state_dict equal bit for bit, and converted again, the
      params equal to the first conversion's;
    - cli.parity --torch-ckpt and --ckpt: PASS at 0.1 mm, exit 0, exactly 4
      B1 + 1 B3 each (the forward's device ms by CUDA events); with the
      NPZ's predictions shifted by 0.5 mm at one joint it must exit 1;
    - parity.run_full (--full) on the ingested tree: a seeded ResNet-50
      state_dict in torchvision's layout, the frames from memory
      (IngestedVideos: no OpenCV to decode the mp4s there), run once to
      extract (13 B5 a dispatch, then 4 B1 + 1 B3), then with the
      reference module's predictions on the extracted features in the
      NPZ: PASS at 0.1 mm, the store reused (4 B1 + 1 B3);
    - cli.doctor with --root, --verify-store, --ckpt, --artifact and
      --dedup-estimate: exit 0, the six kernels reported ready.
    Returns the tools' launch counts (every sub-run's, each checked)."""
    import math

    from h36x_torch.cli import convert, doctor, parity
    from h36x_torch.data.features import FeatureClipDataset
    from h36x_torch.extract import pipeline
    from h36x_torch.models.resnet import ResNet50
    from h36x_torch import infer

    rec = {"phase": "tools", "card": card, "seconds": {}}
    total = dict.fromkeys(counted(), 0)

    def counted_run(name, fn, argv, want, expect_exit=0):
        zero_counts()
        out, seconds = run_cli(fn, argv, expect_exit)
        torch.cuda.synchronize()
        launches = read_counts()
        rec["seconds"][name] = seconds
        rec.setdefault("launches", {})[name] = launches
        if launches != want:
            raise AssertionError(f"{name}: launches {launches} != {want}")
        for k, v in launches.items():
            total[k] += v
        return out

    # the reference checkpoint and NPZ
    t0 = time.perf_counter()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(11)
        ref = TorchPHD()
    ref_sd = to_reference_keys(ref.state_dict())
    ref_pt = os.path.join(tmp, "ref_best.pt")
    torch.save({"model": ref_sd, "epoch": 0}, ref_pt)
    ref = ref.to(dev).eval()
    feats = torch.randn(32, 40, 2048, generator=g)
    with torch.no_grad():
        ref_pred = ref(feats.to(dev)).cpu().numpy()
    npz = os.path.join(tmp, "reference_batch.npz")
    np.savez(npz, video=feats.numpy(),
             joints3d=(0.3 * torch.randn(32, 40, 17, 3, generator=g)).numpy(),
             predicted3djoints=ref_pred)
    rec["seconds"]["reference"] = time.perf_counter() - t0

    # the round trip
    ckdir = os.path.join(tmp, "converted")
    run_cli(convert.main, ["--torch-ckpt", ref_pt, "--out", ckdir, "--name", "best"])
    back_pt = os.path.join(tmp, "back.pt")
    run_cli(convert.main, ["--to-torch-ckpt", os.path.join(ckdir, "best.msgpack"),
                           "--out", back_pt])
    run_cli(convert.main, ["--torch-ckpt", back_pt, "--out", ckdir, "--name", "again"])
    back = torch.load(back_pt, map_location="cpu", weights_only=True)
    same_sd = back.keys() == ref_sd.keys() and all(
        back[k].dtype == ref_sd[k].dtype and torch.equal(back[k], ref_sd[k]) for k in ref_sd)
    rec["round_trip"] = {
        "state_dict_bit_for_bit": same_sd,
        "params_max_diff_again": max_param_diff(os.path.join(ckdir, "best.msgpack"),
                                                os.path.join(ckdir, "again.msgpack")),
        "msgpack_bytes": os.path.getsize(os.path.join(ckdir, "best.msgpack"))}
    if not (same_sd and rec["round_trip"]["params_max_diff_again"] == 0.0):
        raise AssertionError(f"convert round trip: {rec['round_trip']}")

    # the parity forward's device ms: CUDA events around each forward that
    # make_fused_forward builds
    made = infer.make_fused_forward
    forward_ms = []

    def timed_forward(*args, **kwargs):
        fwd = made(*args, **kwargs)

        def run(x):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fwd(x)
            end.record()
            end.synchronize()
            forward_ms.append(start.elapsed_time(end))
            return out

        return run

    one_forward = expect_counts(gn_relu_cconv=4, joint_regressor=1)
    infer.make_fused_forward = timed_forward
    try:
        deltas = {}
        for name, flags in (("torch_ckpt", ["--torch-ckpt", ref_pt]),
                            ("ckpt", ["--ckpt", os.path.join(ckdir, "best.msgpack")])):
            out = counted_run(f"parity_{name}", parity.main,
                              ["--npz", npz, *flags, "--tol-mm", str(PARITY_TOL_MM)],
                              one_forward)
            deltas[name] = parity_delta_mm(out)
            if "-> PASS" not in out:
                raise AssertionError(f"parity --{name}: no PASS")
        data = dict(np.load(npz))
        data["predicted3djoints"] = data["predicted3djoints"].copy()
        data["predicted3djoints"][:, :, 3, 0] += PARITY_SHIFT_M
        shifted = os.path.join(tmp, "shifted.npz")
        np.savez(shifted, **data)
        out = counted_run("parity_shifted", parity.main,
                          ["--npz", shifted, "--torch-ckpt", ref_pt], one_forward,
                          expect_exit=1)
        deltas["shifted_control"] = parity_delta_mm(out)
        if "-> FAIL" not in out:
            raise AssertionError("the shifted control did not FAIL")
        rec["parity_max_delta_mm"] = deltas

        # --full on the ingested tree, frames from memory
        log({"note": "parity --full: the mp4 decode step is not run on the card "
                     "(no OpenCV there); the frames come from memory (IngestedVideos)"})
        videos = IngestedVideos(ingested)
        rn = ResNet50(seed=5, device="cpu")
        rn_sd = dict(rn.state_dict())
        fc = torch.Generator().manual_seed(6)
        rn_sd["fc.weight"] = 0.01 * torch.randn(1000, 2048, generator=fc)
        rn_sd["fc.bias"] = torch.zeros(1000)
        rn_pt = os.path.join(tmp, "resnet50_torchvision.pt")
        torch.save(rn_sd, rn_pt)
        meta, gts = [], []
        for i, ci in enumerate(videos.clips):
            meta.append({"subject": ci.subject, "action": ci.action, "cam": ci.cam,
                         "start": ci.start})
            gts.append(np.asarray(videos.clip_annotations(i)[0], np.float32) / 1000.0)
        npz_full = os.path.join(tmp, "reference_full.npz")
        np.savez(npz_full, joints3d=np.stack(gts), meta=np.array(meta, dtype=object))
        work = os.path.join(tmp, "parity_work")
        args = parity.make_parser().parse_args([
            "--full", "--npz", npz_full, "--resnet-state-dict", rn_pt,
            "--clips-root", ingested, "--torch-ckpt", ref_pt, "--workdir", work,
            "--batch-size", "12", "--num-workers", "4"])
        summaries = []
        extract = pipeline.run_extract

        def recorded_extract(*a, **kw):
            summaries.append(extract(*a, **kw))
            return summaries[-1]

        pipeline.run_extract = recorded_extract
        try:
            zero_counts()
            out, seconds = run_cli(lambda argv: parity.run_full(args, dataset=videos), [])
        finally:
            pipeline.run_extract = extract
        torch.cuda.synchronize()
        launches = read_counts()
        (summary,) = summaries
        dispatches = math.ceil(summary["backbone_frames"] / (12 * 40))
        want = expect_counts(fused_bottleneck=13 * dispatches, gn_relu_cconv=4,
                             joint_regressor=1)
        rec["seconds"]["full_extract"] = seconds
        rec["full_extract"] = {"launches": launches, "dispatches": dispatches,
                               "clips": summary["n_clips"],
                               "backbone_frames": summary["backbone_frames"],
                               "extract_seconds": summary["seconds"],
                               "clips_per_s": summary["clips_per_sec"]}
        if launches != want or summary["n_clips"] != len(videos):
            raise AssertionError(f"parity --full extract: {rec['full_extract']} != {want}")
        for k, v in launches.items():
            total[k] += v
        gt_delta = re.search(r"GT-joints delta store-vs-npz: ([0-9.]+) mm", out)
        rec["full_gt_delta_mm"] = float(gt_delta.group(1))
        if rec["full_gt_delta_mm"] > 1e-3 or "prediction-delta check skipped" not in out:
            raise AssertionError(f"parity --full, first run:\n{out}")

        # the reference's predictions on the extracted features
        store = FeatureClipDataset(os.path.join(work, "features"), test_set=True)
        by_key = {(c["subject"], c["action"], int(c["start"]), c["cam"]): i
                  for i, (c, _) in enumerate(store.items)}
        rows = [by_key[(m["subject"], m["action"], m["start"], m["cam"])] for m in meta]
        with torch.no_grad():
            pred = ref(torch.from_numpy(store.get_batch(rows)[0]).to(dev)).cpu().numpy()
        np.savez(npz_full, joints3d=np.stack(gts), meta=np.array(meta, dtype=object),
                 predicted3djoints=pred)
        out = counted_run("parity_full", lambda argv: parity.run_full(args, dataset=videos),
                          [], one_forward)
        deltas["full"] = parity_delta_mm(out)
        if "-> PASS" not in out or "reusing existing feature store" not in out:
            raise AssertionError(f"parity --full, second run:\n{out}")
    finally:
        infer.make_fused_forward = made
    rec["parity_forward_device_ms"] = forward_ms
    rec["parity_forward_batches"] = {"npz": 32, "full": len(videos)}

    # the doctor
    store_root = os.path.join(work, "features")
    out = counted_run("doctor", doctor.main, [
        "--root", store_root, "--verify-store", store_root,
        "--ckpt", os.path.join(ckdir, "best.msgpack"), "--artifact", artifact,
        "--dedup-estimate", ingested], expect_counts())
    kernels = [ln.strip() for ln in out.splitlines() if ln.startswith("       - ")]
    log({"check": "doctor hopper kernels", "entries": kernels})
    from h36x_torch.ops import _build

    if (len(kernels) != len(_build.SIGNATURES) or "[ok] hopper kernels" not in out
            or "all required checks passed" not in out):
        raise AssertionError(f"doctor:\n{out}")
    log(rec)
    return total

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from h36x_torch.ops import _build

    t_script = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {name}")
    log(smi.splitlines()[0])
    log({"python": sys.version.split()[0], "torch": torch.__version__,
         "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.load(*_build.SIGNATURES)
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "nvcc_seconds": _build.build_seconds})
    for src, text in _build.build_logs.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    kernels = [check_temporal(dev, g), check_temporal_bwd(dev, g),
               check_regressor(dev, g), check_regressor_bwd(dev, g),
               check_bottleneck(dev, frames_per_dispatch()), check_matmul_probe(dev)]
    check_train_step(dev, g)
    check_graphed_train_step(dev, g, smi.splitlines()[0])
    check_backbone(dev, frames_per_dispatch())

    # the main paths, each with the counts set to 0 just before it
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths["serve"] = drive_main_path(dev, g, tmp)
    keep = tempfile.TemporaryDirectory()  # the f32 artifact, for the doctor
    with tempfile.TemporaryDirectory() as tmp:
        paths["serve_artifact"] = drive_artifact_path(dev, g, tmp, smi.splitlines()[0])
        for kept in ("f32.pt2", "f32.pt2.json"):
            shutil.copy(os.path.join(tmp, kept), keep.name)
    with tempfile.TemporaryDirectory() as tmp:
        paths["train"] = drive_train_path(g, tmp)
        base_rows = read_rows(os.path.join(tmp, "runs"))
        paths.update(drive_grouped_train_paths(tmp, base_rows))
        t0 = time.perf_counter()
        paths.update(drive_dist_train_path(tmp, base_rows, smi.splitlines()[0]))
        log({"phase": "train_dist total", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        paths.update(drive_orbax_tp_path(dev, torch.Generator().manual_seed(12), tmp,
                                         base_rows, smi.splitlines()[0]))
        log({"phase": "orbax_tp total", "seconds": time.perf_counter() - t0})
        paths.update(drive_bf16_train_paths(dev, tmp, smi.splitlines()[0]))
    t0 = time.perf_counter()
    e = EXTRACT
    videos = SyntheticVideos(0, e["videos"], e["frames"], e["raw"], e["seq_len"], e["stride"])
    log({"phase": "videos_made", "seconds": time.perf_counter() - t0,
         "clips": len(videos), **e})
    with tempfile.TemporaryDirectory() as tmp:
        for engine in ("opt", "flax"):
            paths[f"extract_{engine}"], _ = drive_extract_path(
                dev, videos, os.path.join(tmp, engine), engine)
        compare_stores(os.path.join(tmp, "opt"), os.path.join(tmp, "flax"), dev)
    del videos
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ingested = drive_ingest_path(tmp)
        log({"phase": "ingest total", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        check_crop_resize(dev, smi.splitlines()[0])
        log({"phase": "crop_resize total", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        paths.update(drive_partitioned_extract(dev, ingested, tmp, smi.splitlines()[0]))
        log({"phase": "extract_partitioned total", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        paths["tools"] = drive_tools_path(dev, g, tmp, smi.splitlines()[0], ingested,
                                          os.path.join(keep.name, "f32.pt2"))
        log({"phase": "tools total", "seconds": time.perf_counter() - t0})
    keep.cleanup()
    with tempfile.TemporaryDirectory() as tmp:
        paths["predict"] = drive_predict_path(dev, g, tmp)
    paths["probe"] = drive_probe_path()
    log({"phase": "total", "seconds": time.perf_counter() - t_script})
    for k in kernels:
        k["launches_by_path"] = {p: counts[k["name"]] for p, counts in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        log(dict(k))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extras = ("modes", "routes", "kernel_route", "general_ms", "pass_bound_ms")
    log({"kernels": [{**{key: k[key] for key in keys},
                      **{extra: k[extra] for extra in extras if extra in k}}
                     for k in kernels]})
    log(smi.splitlines()[0])
    log({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--train-worker":
        sys.exit(train_worker(sys.argv[2], sys.argv[3:]))
    if len(sys.argv) > 2 and sys.argv[1] == "--control-worker":
        sys.exit(train_worker(sys.argv[2], sys.argv[3:], split=2))
    sys.exit(main())
