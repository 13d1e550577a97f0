"""Wall-clock phase timers (counterpart of h36x/utils/timers.py): the
training loop's data / step / drain split, and the process-wide table of
`utils.profiling`'s spans and counters.

Safe across threads: each thread times its own start of a phase, and the
totals, call counts and counters change under one lock."""

from __future__ import annotations

import threading
import time
from collections import defaultdict


class PhaseTimers:
    def __init__(self):
        self.totals = defaultdict(float)
        self.calls = defaultdict(int)
        self.counts = defaultdict(int)
        self.counted = defaultdict(int)  # count() calls a counter
        self._start = {}
        self._lock = threading.Lock()

    def start(self, phase: str) -> None:
        self._start[phase, threading.get_ident()] = time.perf_counter()

    def stop(self, phase: str) -> float:
        dt = time.perf_counter() - self._start.pop((phase, threading.get_ident()))
        self.add(phase, dt)
        return dt

    def add(self, phase: str, seconds: float) -> None:
        """One call of `phase` that took `seconds`."""
        with self._lock:
            self.totals[phase] += seconds
            self.calls[phase] += 1

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] += n
            self.counted[name] += 1

    def snapshot(self) -> dict:
        """A copy: {"spans": {phase: (seconds, calls)}, "counts": {name: n},
        "counted": {name: count() calls}}."""
        with self._lock:
            return {"spans": {k: (v, self.calls[k]) for k, v in self.totals.items()},
                    "counts": dict(self.counts), "counted": dict(self.counted)}

    def summary(self, n_iters: int = 1) -> str:
        lines = []
        for phase, total in sorted(self.totals.items()):
            lines.append(f"  {phase:<16s} {total:8.2f}s  ({total / max(n_iters, 1):.4f}s/iter)")
        return "\n".join(lines)
