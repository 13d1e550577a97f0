"""Serving cells: the dynamic-batching daemon in checkpoint mode under an
open-loop Poisson load.

Set-up makes PHD's weights from the seed on the card, writes them as a
checkpoint with the program's writer into the run's directory, builds the
daemon's predict function from it (`serve_daemon.build_predict_fn`, fast
mode, B1 + B3), runs it once at every batch size up to the cell's
`max_batch`, starts `serve_daemon.BatchingServer` on a unix socket in this
process, and starts the load generator (portbench/loadgen.py) in a child
process. The window opens when the generator is told to go and closes when
its last request is answered (or `grace` seconds after its last arrival).
A traced run traces the whole window.

The latency of a request runs from its scheduled send time to its reply;
one that fails or is refused counts as failed and, in the tail, as
slower than any limit. After the window the reference
(portbench/reference/phd.py, float32) runs each of the bank's clips once;
every reply was folded by the generator into its clip's element-wise
envelope, and the check is the widest relative gap of an envelope from the
reference's joints. A request that got no reply at all is counted apart.
"""

from __future__ import annotations

import asyncio
import collections
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from portbench import synth, trace
from portbench.harness import HERE, Outcome, Run
from portbench.reference import phd as ref_phd
from portbench.roofline import over_batches, phd_forward_units

ARCH = ("latent_dim", "feature_dim", "joints_num", "num_blocks", "ar_num_blocks",
        "groups", "kernel_size", "regressor_iters", "regressor_hidden")


class Timed:
    """The predict function, counting calls, rows, host milliseconds and
    the calls of each batch size."""

    def __init__(self, fn):
        self.fn = fn
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        self.calls = self.rows = 0
        self.ms = 0.0
        self.sizes = collections.Counter()

    def __call__(self, feats):
        t0 = time.perf_counter()
        out = self.fn(feats)
        dt = (time.perf_counter() - t0) * 1e3
        with self.lock:
            self.calls += 1
            self.rows += int(feats.shape[0])
            self.ms += dt
            self.sizes[int(feats.shape[0])] += 1
        return out

    def snapshot(self):
        with self.lock:
            return self.calls, self.rows, self.ms, dict(self.sizes)


def write_checkpoint(run: Run) -> str:
    from h36x_torch.cli.common import build_model_from_arch
    from h36x_torch.train.checkpoint import save_checkpoint
    from h36x_torch.train.state import make_optimizer

    cfg = run.cell.config
    model = build_model_from_arch({k: cfg[k] for k in ARCH}, device=run.device)
    w = synth.phd_weights(cfg, run.seed, run.device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w[name])
    optimizer, _ = make_optimizer(model, 1e-4)
    save_checkpoint(run.workdir / "ckpt", "best", model, optimizer, 0, float("inf"), 0)
    return str(run.workdir / "ckpt" / "best.msgpack")


def make_predict(run: Run, ckpt: str):
    """The daemon's predict function from the checkpoint (the program)."""
    from h36x_torch.serve_daemon import build_predict_fn

    cfg = run.cell.config
    predict, _ = build_predict_fn(
        model_path=ckpt, seq_len=cfg["seq_len"], max_batch=run.cell.spec["max_batch"],
        device=run.device, precise=False, ar_blocks=cfg["ar_num_blocks"],
        **{k: cfg[k] for k in ARCH if k != "ar_num_blocks"})
    return predict


def _median(values):
    done = [x for x in values if x is not None]
    return statistics.median(done) if done else None


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))


def run(run: Run) -> Outcome:
    from h36x_torch.ops.regressor import fused_joint_regressor
    from h36x_torch.ops.temporal import fused_gn_relu_cconv
    from h36x_torch.serve_daemon import BatchingServer

    cfg, spec, dev = run.cell.config, run.cell.spec, run.device
    cuda = dev.type == "cuda"
    T, F = cfg["seq_len"], cfg["feature_dim"]
    # the generator starts first: its start-up overlaps the model's
    sock = run.workdir / "d.sock"
    params = {"socket": str(sock), "seed": run.seed, "seconds": run.seconds,
              "rate": spec["rate"], "bank": spec["bank"], "seq_len": T, "feature_dim": F,
              "grace": spec["grace"], "out": str(run.workdir / "load.json")}
    # the generator gets a core of its own, as a client on another host
    # would, and one thread: what it spends is not the daemon's time
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) >= 4:
        params["cpu"] = cpus[-1]
    (run.workdir / "load_params.json").write_text(json.dumps(params))
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    child = subprocess.Popen([sys.executable, "-m", "portbench.loadgen",
                              str(run.workdir / "load_params.json")],
                             cwd=HERE.parent, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             text=True, env=env)
    if "cpu" in params:
        os.sched_setaffinity(0, cpus[:-1])
    phases = {"generator_started": time.perf_counter() - run.t_start}
    box: dict = {}
    try:
        predict = Timed(make_predict(run, write_checkpoint(run)))
        phases["predict_built"] = time.perf_counter() - run.t_start
        for b in range(1, spec["max_batch"] + 1):
            predict(np.zeros((b, T, F), np.float32))
        predict.reset()
        phases["warmed"] = time.perf_counter() - run.t_start
        server = BatchingServer(predict, T, F, max_batch=spec["max_batch"],
                                max_wait_ms=spec["max_wait_ms"], max_queue=spec["max_queue"])
        b1, b3 = fused_gn_relu_cconv.launches, fused_joint_regressor.launches
        asyncio.run(_serve(run, server, predict, child, sock, box, cuda))
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
        os.sched_setaffinity(0, cpus)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if "trace" in box:
        box["trace"].finish()
    launches = {"B1": fused_gn_relu_cconv.launches - b1,
                "B3": fused_joint_regressor.launches - b3}
    with open(run.workdir / "load.json") as f:
        load = json.load(f)
    del server, predict
    if cuda:
        torch.cuda.empty_cache()

    lat = load["latency_ms"]
    window_ms = 1e3 * box["window_s"]
    done = [x for x in lat if x is not None]
    failed = len(lat) - len(done)
    tail = p95([x if x is not None else 10 * window_ms for x in lat])
    calls, rows, ms = box["calls"], box["rows"], box["ms"]
    checks = [("reply_gap", reply_gap(run, load["envelope"]), spec["limits"]["reply_gap"]),
              ("unanswered", float(load["lost"]), 0.0)]
    record = {"window_s": box["window_s"], "rows": rows, "batches": box["batches"],
              "device_call_ms": ms / calls if calls else None}
    if "trace" in box:
        # the trace spans the window: every batch the daemon ran, each
        # reading the weights once
        flops, bound = over_batches(lambda n: phd_forward_units(cfg, n, w=2), box["sizes"])
        record.update(traced_window_s=box["trace"].host_s, traced_flops=flops,
                      traced_bound_s=bound)
    return Outcome(
        setup_s=box["setup_s"], e2e={"serve_p95_ms": tail}, record=record,
        attempted=len(lat), failed=failed, checks=checks, memory_peak_bytes=peak,
        trace=box["trace"].summary if "trace" in box else None,
        proof={"requests": len(lat), "answered": len(done),
               "p50_ms": statistics.median(done) if done else None,
               "p50_ms_first_fifth": _median(lat[:len(lat) // 5]),
               "p50_ms_last_fifth": _median(lat[-(len(lat) // 5):]),
               "lost": load["lost"],
               "generator_late_ms": load["late_ms"], "errors": load["errors"],
               "rows": rows, "batches": box["batches"], "launches": launches,
               "rate": spec["rate"], "setup_phases_s": phases})


async def _serve(run, server, predict, child, sock, box, cuda):
    loop = asyncio.get_running_loop()
    srv = await server.start(unix_path=str(sock))
    try:
        line = await loop.run_in_executor(None, child.stdout.readline)
        if line.strip() != "ready":
            raise RuntimeError(f"the load generator did not start: {line!r}")
        stats0 = dict(server.stats)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        # the profiler starts and stops outside the window: either blocks the
        # event loop, and the daemon with it, while it runs
        tr = trace.Trace(run.workdir / "trace.json", cuda) if run.trace else None
        if tr is not None:
            tr.__enter__()
        t0 = time.perf_counter()
        box["setup_s"] = t0 - run.t_start
        child.stdin.write("go\n")
        child.stdin.flush()
        line = await loop.run_in_executor(None, child.stdout.readline)
        box["window_s"] = time.perf_counter() - t0
        if tr is not None:
            tr.__exit__(None, None, None)
            box["trace"] = tr
        if line.strip() != "done":
            raise RuntimeError(f"the load generator failed: {line!r}")
        box["calls"], box["rows"], box["ms"], box["sizes"] = predict.snapshot()
        box["batches"] = server.stats["batches"] - stats0["batches"]
    finally:
        srv.close()
        server.stop()
        for w in list(server._writers):
            w.close()
        await srv.wait_closed()


def reply_gap(run: Run, envelope: dict) -> float:
    """The widest gap of a clip's replies from the reference's joints:
    the norm of the element-wise larger of |min - ref| and |max - ref|
    over the norm of ref."""
    cfg, dev = run.cell.config, run.device
    clips = sorted(int(c) for c in envelope)
    if not clips:
        return float("inf")
    w = synth.phd_weights(cfg, run.seed, dev)
    bank = synth.clip_bank(cfg, run.seed, run.cell.spec["bank"])[clips].to(dev)
    with torch.no_grad():
        ref = ref_phd.forward(w, bank, cfg).double().cpu()
    worst = 0.0
    for i, c in enumerate(clips):
        lo, hi = (torch.tensor(v, dtype=torch.float64) for v in envelope[str(c)])
        dev_ = torch.maximum((lo - ref[i]).abs(), (hi - ref[i]).abs())
        worst = max(worst, float(dev_.norm() / ref[i].norm()))
    return worst
