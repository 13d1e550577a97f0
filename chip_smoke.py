#!/usr/bin/env python3
"""Drive the h36x_torch serving path once on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Setup: prints the card and its power limit, builds the CUDA kernels from
   h36x_torch/ops/csrc/ (one nvcc per source, all started together).
2. Each kernel against its plain PyTorch version on the card (TF32 off), at
   the serving shapes and the edge cases, within the stated tolerance; then
   its time, its plain version's time and its bound.
3. The slice end to end at full model width: a seeded PHDFor3DJoints is
   saved as a checkpoint, served by the port's BatchingServer on a local
   socket, and answers 16 concurrent and 3 sequential (40, 2048) requests
   and a stats query; every reply is held against the plain forward of its
   row; the launch counters must show 4 temporal and 1 regressor launches
   per device batch. phd_forward_fused(predict_future=True) with kernels is
   held against its plain version too (f_AR and the second regressor pass).
4. Prints one {"kernels": [...]} line, then the last line
   {"ok": true, "device": {...}}.

Any failure raises and exits nonzero; without CUDA it exits nonzero at once.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_F32_FLOPS = 67e12  # H100 SXM FP32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth (data sheet)
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)  # FP32 both sides; sums reordered
E2E_TOL = dict(rtol=1e-3, atol=1e-4)  # full forward (tests/test_pallas.py)


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


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict) -> dict:
    torch.cuda.synchronize()
    err = (got - want).abs()
    rec = {"check": name, "shape": list(got.shape),
           "max_abs_err": float(err.max()),
           "max_rel_err": float(err.max() / want.abs().max().clamp_min(1e-30)),
           "tol": tol, "finite": bool(torch.isfinite(got).all())}
    ok = rec["finite"] and torch.allclose(got, want, **tol)
    log(rec)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return rec


def uniform(shape, fan_in, g, device):
    b = 1.0 / fan_in ** 0.5
    return (torch.rand(shape, generator=g) * 2 * b - b).to(device)


def check_temporal(dev, g):
    from h36x_torch.ops.temporal import fused_gn_relu_cconv, reference_gn_relu_cconv

    d = o = 1024
    k, groups = 3, 32
    w = uniform((k, d, o), k * d, g, dev)
    cb = uniform((o,), k * d, g, dev)
    scale = (1 + 0.1 * torch.randn(d, generator=g)).to(dev)
    bias = (0.1 * torch.randn(d, generator=g)).to(dev)
    worst = worst_rel = 0.0
    for b, t, with_res in ((16, 40, False), (16, 40, True), (16, 1, False),
                           (16, 2, True), (16, 3, False), (1, 40, True)):
        x = (2 * torch.randn(b, t, d, generator=g) + 0.5).to(dev)
        res = torch.randn(b, t, o, generator=g).to(dev) if with_res else None
        got = fused_gn_relu_cconv(x, scale, bias, w, cb, res, groups=groups)
        want = reference_gn_relu_cconv(x, scale, bias, w, cb, res, groups=groups)
        rec = compare(f"temporal B={b} T={t} residual={with_res}", got, want,
                      KERNEL_TOL)
        worst = max(worst, rec["max_abs_err"])
        worst_rel = max(worst_rel, rec["max_rel_err"])
        if (b, t, with_res) == (16, 40, False):
            flagship = x
    x = flagship
    b, t, _ = x.shape
    ms = time_ms(lambda: fused_gn_relu_cconv(x, scale, bias, w, cb, groups=groups))
    plain_ms = time_ms(lambda: reference_gn_relu_cconv(x, scale, bias, w, cb,
                                                       groups=groups))
    flops = 2 * b * t * o * k * d + 10 * b * t * d + b * t * o
    nbytes = 4 * (b * t * d + 2 * d + k * d * o + o + b * t * o)
    bound_ms, bound_by = bound(flops, nbytes)
    return {"name": "gn_relu_cconv", "route": "cuda",
            "source": "h36x_torch/ops/csrc/temporal.cu",
            "replaces": "h36x/ops/pallas_temporal.py:42",
            "max_abs_err": worst,
            "max_rel_err": worst_rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": f"B={b} T={t} D={d} O={o} K={k} G={groups}",
            "tol": KERNEL_TOL}


def check_regressor(dev, g):
    from h36x_torch.ops.regressor import _reference_forward, fused_joint_regressor

    d = h = 1024
    p, iters = 51, 3
    ws = (uniform((d + p, h), d + p, g, dev), uniform((h,), d + p, g, dev),
          uniform((h, h), h, g, dev), uniform((h,), h, g, dev),
          uniform((h, p), h, g, dev), uniform((p,), h, g, dev))
    worst = worst_rel = 0.0
    for n in (640, 13):
        phi = torch.randn(n, d, generator=g).to(dev)
        got = fused_joint_regressor(phi, *ws, iters, p)
        want = _reference_forward(phi, *ws, iters, p)
        rec = compare(f"regressor N={n}", got, want, KERNEL_TOL)
        worst = max(worst, rec["max_abs_err"])
        worst_rel = max(worst_rel, rec["max_rel_err"])
        if n == 640:
            flagship = phi
    n = flagship.shape[0]
    ms = time_ms(lambda: fused_joint_regressor(flagship, *ws, iters, p))
    plain_ms = time_ms(lambda: _reference_forward(flagship, *ws, iters, p))
    flops = 2 * n * d * h + iters * (2 * n * p * h + 2 * n * h * h
                                     + 2 * n * h * p + 4 * n * h + 2 * n * p)
    nbytes = 4 * (n * d + (d + p) * h + h + h * h + h + h * p + p + n * p)
    bound_ms, bound_by = bound(flops, nbytes)
    return {"name": "joint_regressor", "route": "cuda",
            "source": "h36x_torch/ops/csrc/regressor.cu",
            "replaces": "h36x/ops/pallas_regressor.py:39",
            "max_abs_err": worst,
            "max_rel_err": worst_rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": f"N={n} D={d} H={h} P={p} iters={iters}",
            "tol": KERNEL_TOL}


async def drive_daemon(server, feats_conc, feats_seq, sock_dir):
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
        seq = [await request_async(f, timeout_s=120, **bind) for f in feats_seq]
        stats = await stats_async(timeout_s=30, **bind)
    finally:
        server.stop()
        srv.close()
        for w in list(server._writers):
            w.close()
        await srv.wait_closed()
    return conc + seq, stats


def drive_main_path(dev, g, sock_dir):
    from h36x_torch.config import SEQ_LEN, ModelConfig
    from h36x_torch.infer import make_fused_forward, phd_forward_fused
    from h36x_torch.models.phd import PHDFor3DJoints, param_tree
    from h36x_torch.ops.regressor import fused_joint_regressor
    from h36x_torch.ops.temporal import fused_gn_relu_cconv
    from h36x_torch.serve_daemon import BatchingServer, build_predict_fn
    from h36x_torch.train.checkpoint import save_params

    mc = ModelConfig()
    t0 = time.perf_counter()
    model = PHDFor3DJoints(generator=torch.Generator().manual_seed(0), device="cpu")
    path = save_params(sock_dir, "best", model.state_dict(),
                       config={"model": dataclasses.asdict(mc),
                               "data": {"seq_len": SEQ_LEN}})
    predict_fn = build_predict_fn(model_path=str(path), max_batch=16, warm=True)
    log({"phase": "daemon_ready", "seconds": time.perf_counter() - t0,
         "checkpoint_bytes": os.path.getsize(path)})
    server = BatchingServer(predict_fn, seq_len=SEQ_LEN,
                            feature_dim=mc.feature_dim, max_batch=16,
                            max_wait_ms=5.0)
    feats = torch.randn(19, SEQ_LEN, mc.feature_dim, generator=g).numpy()

    fused_gn_relu_cconv.launches = 0
    fused_joint_regressor.launches = 0
    replies, stats = asyncio.run(drive_daemon(server, list(feats[:16]),
                                              list(feats[16:]), sock_dir))
    launches = {"gn_relu_cconv": fused_gn_relu_cconv.launches,
                "joint_regressor": fused_joint_regressor.launches}

    batches = stats["batches"]
    log({"phase": "daemon", "requests": stats["requests"], "batches": batches,
         "rows": stats["rows"], "launches": launches,
         "request_ms_p50": stats["request_ms"]["p50"],
         "request_ms_p99": stats["request_ms"]["p99"],
         "device_ms_p50": stats["batch_device_ms"]["p50"],
         "device_ms_p99": stats["batch_device_ms"]["p99"]})
    if stats["requests"] != 19 or stats["rows"] != 19:
        raise AssertionError(f"daemon served {stats['requests']} requests, "
                             f"{stats['rows']} rows; sent 19")
    want_launches = {"gn_relu_cconv": 2 * mc.num_blocks * batches,
                     "joint_regressor": batches}
    if launches != want_launches:
        raise AssertionError(f"launch counts {launches} != {want_launches} "
                             f"for {batches} device batches")

    model.to(dev)
    params = param_tree(model)
    plain = make_fused_forward(use_kernels=False)
    for i, reply in enumerate(replies):
        want = plain(params, torch.from_numpy(feats[i:i + 1]).to(dev))[0]
        got = torch.from_numpy(np.array(reply)).to(dev)
        if got.shape != want.shape:
            raise AssertionError(f"reply {i}: shape {tuple(got.shape)}")
        if not (torch.isfinite(got).all() and torch.allclose(got, want, **E2E_TOL)):
            compare(f"daemon reply {i}", got, want, E2E_TOL)
    log({"check": "daemon replies vs plain forward", "replies": len(replies),
         "tol": E2E_TOL, "ok": True})

    # phd_forward_fused with f_AR and the second regressor pass
    x = torch.from_numpy(feats[:16]).to(dev)
    before = (fused_gn_relu_cconv.launches, fused_joint_regressor.launches)
    with torch.inference_mode():
        got = phd_forward_fused(params, x, predict_future=True)
        want = phd_forward_fused(params, x, predict_future=True, use_kernels=False)
    for name, a, b in zip(("phi", "phi_hat", "joints_phi", "joints_hat"), got, want):
        compare(f"phd_forward_fused {name}", a, b, E2E_TOL)
    grown = (fused_gn_relu_cconv.launches - before[0],
             fused_joint_regressor.launches - before[1])
    if grown != (2 * (mc.num_blocks + mc.ar_num_blocks), 2):
        raise AssertionError(f"phd_forward_fused launched {grown}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from h36x_torch.ops import _build

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
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    kernels = [check_temporal(dev, g), check_regressor(dev, g)]

    with tempfile.TemporaryDirectory() as tmp:
        launches = drive_main_path(dev, g, tmp)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        log(dict(k))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log({"kernels": [{key: k[key] for key in keys} for k in kernels]})
    log(smi.splitlines()[0])
    log({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
