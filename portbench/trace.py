"""The traced window: torch.profiler over a region, read back into the
device's busy time, the window's length, the device operations that took
the most time and the idle gaps by what the host was doing."""

from __future__ import annotations

import bisect
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

WINDOW = "portbench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"user_annotation", "cpu_op", "cuda_runtime", "cuda_driver"}
TOP = 10


class Trace:
    """with Trace(path) as tr: ...; later tr.finish() -> tr.summary: busy_s,
    window_s, device_ops, idle_gaps (None when the trace holds no device
    operation). Leaving the region stops the profiler; finish() writes and
    reads the trace, outside the measured window. `host_s` is the region's
    length on the host's clock."""

    def __init__(self, path: Path, cuda: bool):
        self.path = Path(path)
        self.cuda = cuda
        self.summary = None
        self.host_s = 0.0

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.host_s = time.perf_counter() - self._t0
        self._span.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        return False

    def finish(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        with open(self.path) as f:
            self.summary = summarize(json.load(f)["traceEvents"])
        self.path.unlink()
        del self._prof
        return self.summary


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events) -> dict | None:
    """Chrome-trace events -> {busy_s, window_s, device_ops, idle_gaps}."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    w = spans[0]
    w0, w1, tid = float(w["ts"]), float(w["ts"]) + float(w["dur"]), w.get("tid")
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b, e["name"]))
        elif cat in HOST_CATS and e["name"] != WINDOW:
            host.append((a, b, e["name"], e.get("tid") == tid))
    if not dev:
        return None
    busy = _merge([(a, b) for a, b, _ in dev])
    by_op = defaultdict(float)
    for a, b, name in dev:
        by_op[name] += (b - a) * 1e-6
    # idle gaps inside the window, each named by the innermost host event
    # covering its middle (the main thread's first)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    mids = np.array([(a + b) / 2 for a, b in gaps])
    label = [None] * len(gaps)
    best = np.full(len(gaps), np.inf)
    for main in (True, False):
        for a, b, name, on_main in host:
            if on_main != main:
                continue
            lo, hi = bisect.bisect_left(mids, a), bisect.bisect_right(mids, b)
            for i in range(lo, hi):
                if (label[i] is None or (label[i][1] == main and b - a < best[i])):
                    label[i], best[i] = (name, main), b - a
    by_gap = defaultdict(float)
    for (a, b), lab in zip(gaps, label):
        name = "host outside any traced op" if lab is None else (
            lab[0] if lab[1] else f"{lab[0]} (other thread)")
        by_gap[name] += (b - a) * 1e-6
    top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "device_ops": top(by_op), "idle_gaps": top(by_gap)}
