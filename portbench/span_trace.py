"""A traced window whose device time is also read by the program's spans:
each kernel, copy or memset belongs to the innermost span of a given
prefix (the program's `h36x.vit.*`) whose host interval holds the launch
that enqueued it, matched through the trace's `correlation` ids (the
launch's runtime event and the device event carry the same one).

    with SpanTrace(path, cuda, "h36x.vit.") as tr: ...
    tr.finish()  # tr.summary as trace.Trace's; tr.device_s {span: seconds}

The trace file is read once, for both, before it is removed.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from portbench import trace

LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


class SpanTrace(trace.Trace):
    def __init__(self, path, cuda: bool, prefix: str):
        super().__init__(path, cuda)
        self.prefix = prefix
        self.device_s = {}

    def finish(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        self.summary = trace.summarize(events)
        self.device_s = device_s_by_span(events, self.prefix)
        self.path.unlink()
        del self._prof
        return self.summary


def _correlation(e):
    args = e.get("args") or {}
    return args.get("correlation", args.get("correlation id"))


def device_s_by_span(events, prefix: str) -> dict:
    """{span name: device seconds} of the device events launched inside the
    host spans named `prefix`..., each to the innermost one (the shortest
    holding the launch) on the launching thread. Events launched outside
    every such span are left out."""
    spans = defaultdict(list)  # tid -> [(start, end, name)]
    launches = {}  # correlation -> (ts, tid)
    device = []  # (correlation, seconds)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat == "user_annotation" and str(e.get("name", "")).startswith(prefix):
            spans[e.get("tid")].append((ts, ts + dur, e["name"]))
        elif cat in LAUNCH_CATS and _correlation(e) is not None:
            launches[_correlation(e)] = (ts, e.get("tid"))
        elif cat in trace.DEVICE_CATS and _correlation(e) is not None:
            device.append((_correlation(e), dur * 1e-6))
    starts = {}
    for tid, lst in spans.items():
        lst.sort()
        starts[tid] = [a for a, _, _ in lst]
    out = defaultdict(float)
    for corr, seconds in device:
        if corr not in launches:
            continue
        ts, tid = launches[corr]
        lst = spans.get(tid)
        if not lst:
            continue
        best = None
        for a, b, name in reversed(lst[:bisect.bisect_right(starts[tid], ts)]):
            if b >= ts and (best is None or b - a < best[0]):
                best = (b - a, name)
        if best is not None:
            out[best[1]] += seconds
    return dict(out)
