"""Profiling hooks (counterpart of h36x/utils/profiling.py): a
torch.profiler trace of a region and named regions inside it.

The trainer's `--profile-dir` traces its first epoch (the first resumed
epoch on --resume): one epoch bounds the trace's size, and every epoch runs
the same step. The trace is a Chrome trace file (chrome://tracing,
Perfetto) in the directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


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


def step_annotation(name: str):
    """A named region that shows in profiler traces (record_function)."""
    return torch.profiler.record_function(name)
