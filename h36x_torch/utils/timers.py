"""Wall-clock phase timers (counterpart of h36x/utils/timers.py): the
training loop's data / step / drain split."""

from __future__ import annotations

import time
from collections import defaultdict


class PhaseTimers:
    def __init__(self):
        self.totals = defaultdict(float)
        self._start = {}

    def start(self, phase: str) -> None:
        self._start[phase] = time.perf_counter()

    def stop(self, phase: str) -> float:
        dt = time.perf_counter() - self._start.pop(phase)
        self.totals[phase] += dt
        return dt

    def add(self, phase: str, seconds: float) -> None:
        self.totals[phase] += seconds

    def summary(self, n_iters: int = 1) -> str:
        lines = []
        for phase, total in sorted(self.totals.items()):
            lines.append(f"  {phase:<16s} {total:8.2f}s  ({total / max(n_iters, 1):.4f}s/iter)")
        return "\n".join(lines)
