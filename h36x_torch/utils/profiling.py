"""Profiling hooks (counterpart of h36x/utils/profiling.py): a
torch.profiler trace of a region, and spans and counters inside it.

The trainer's `--profile-dir` traces its first epoch (the first resumed
epoch on --resume): one epoch bounds the trace's size, and every epoch runs
the same step. The trace is a Chrome trace file (chrome://tracing,
Perfetto) in the directory.

`span(name)` adds its seconds and one call under `name` to one
process-wide table (a :class:`h36x_torch.utils.timers.PhaseTimers`), on any
thread; `count(name, n)` adds to a counter there. While a profiler runs
on the calling thread, a span is also a `record_function` region, so it
lands on the trace's timeline beside the device's work. torch.profiler
records no region opened on another Python thread than the one that
started it: spans on worker threads reach the table only. `totals()`
copies the table; `since(before)` is what it gained after a copy;
`measured(name, fn, ...)` runs `fn` under a span and merges that gain into
the summary it returns, and keeps it for `measured_calls(name)`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque
from typing import Iterator, Optional

import torch

from h36x_torch.utils.timers import PhaseTimers

_TABLE = PhaseTimers()
_CALLS = defaultdict(lambda: deque(maxlen=1024))  # name -> measured() gains


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str], device=None) -> Iterator[None]:
    """A torch.profiler trace of the region — host activity, plus the
    card's when `device` is a CUDA device (or, when None, CUDA is there) —
    written to <profile_dir>/trace_<pid>_<time>.json; a no-op when
    profile_dir is empty."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(profile_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
    prof.export_chrome_trace(path)
    print(f"Profiler trace written to {path}", flush=True)


class span:
    """with span(name): ... — the region's seconds and one call added to
    the table under `name`; a `record_function` region too while a
    profiler runs on this thread (built only then: one costs 10-15 us,
    the span alone about 2 us)."""

    __slots__ = ("name", "_t0", "_region")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._region = None
        if torch._C._autograd._profiler_enabled():
            self._region = torch.profiler.record_function(self.name)
            self._region.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        if self._region is not None:
            self._region.__exit__(*exc)
        _TABLE.add(self.name, dt * 1e-9)
        return False


def count(name: str, n: int = 1) -> None:
    """Add `n` to the table's counter `name`."""
    _TABLE.count(name, n)


def totals() -> dict:
    """A copy of the table: {"spans": {name: (seconds, calls)},
    "counts": {name: n}, "counted": {name: count() calls}}, since the
    process started."""
    return _TABLE.snapshot()


def since(before: dict) -> dict:
    """What the table gained after `before` (a totals() copy):
    {"host_s": {name: (seconds, calls)}, "counts": {name: n}}, spans that
    did not run and counters not counted left out (a counter counted by 0
    reads 0)."""
    now = totals()
    s0, c0, k0 = before["spans"], before["counts"], before["counted"]
    host = {}
    for name, (sec, calls) in now["spans"].items():
        sec0, calls0 = s0.get(name, (0.0, 0))
        if calls > calls0:
            host[name] = (sec - sec0, calls - calls0)
    return {"host_s": host,
            "counts": {k: n - c0.get(k, 0) for k, n in now["counts"].items()
                       if now["counted"][k] != k0.get(k, 0)}}


def measured(name: str, fn, *args, **kwargs) -> dict:
    """fn(*args, **kwargs) under span(name); its summary dict with
    since()'s `host_s` and `counts` of the call merged in. The gain is kept
    too, the last 1,024 a name, for measured_calls()."""
    before = totals()
    with span(name):
        summary = fn(*args, **kwargs)
    gained = since(before)
    _CALLS[name].append(gained)
    return dict(summary, **gained)


def measured_calls(name: str) -> list:
    """The kept gains of measured(name, ...), oldest first: a call at a
    time, where the table sums every call since the process started."""
    return list(_CALLS.get(name, ()))
