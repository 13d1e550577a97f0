"""The open-loop load generator of the serving cells, run as a child
process of the benchmark:

    python3 -m portbench.loadgen PARAMS.json

PARAMS: socket (unix socket path), seed, seconds, rate (requests/s),
bank (distinct clips), seq_len, feature_dim, out (result path), and
optionally cpu (the one core it runs on). It makes
its clips from the seed (portbench.seeds.clip_bank), draws a fixed number
of arrivals, round(rate * seconds), as exponential gaps scaled to span the
window exactly, and a clip per arrival, then prints "ready" and waits for
"go" on standard input. Each request is spawned at its scheduled time and
sent on an idle connection of a pool (a new one when none is idle),
whatever the replies before it, and timed from its scheduled time to its
reply's last byte; how late the spawn came is kept. After the last
arrival it waits up to `grace` seconds for the replies still due.

The result (JSON): per request its latency in ms (None for an error or no
reply), the refusals by message (the daemon's error replies and connects
it did not take), the requests sent and never answered (`lost`), how late
the generator sent (ms, quantiles), and per clip the element-wise min and
max of all replies for it, as lists; the benchmark holds every reply to
the reference through that envelope.

The wire format is the daemon's: 8-byte big-endian header length, JSON
header, raw payload. The generator is the yardstick, not the system: it
imports no torch, keeps only the requests in flight, and runs the window
with its garbage collector off, so that no pause of its own is timed as
the daemon's latency.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import struct
import sys
import time

import numpy as np

from portbench.seeds import clip_bank, sub_seed

_LEN = struct.Struct(">Q")


def schedule(seed: int, rate: float, seconds: float, bank: int):
    """(send times in s from the start, clip index of each request)."""
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng(sub_seed(seed, "arrivals"))
    gaps = rng.exponential(1.0, n)
    times = np.cumsum(gaps) * (seconds / gaps.sum())
    clips = np.random.default_rng(sub_seed(seed, "clips")).integers(0, bank, n)
    return times - times[0], clips


async def _read_msg(reader):
    (hlen,) = _LEN.unpack(await reader.readexactly(_LEN.size))
    header = json.loads(await reader.readexactly(hlen))
    n = int(header.get("nbytes", 0))
    return header, (await reader.readexactly(n) if n else b"")


def _frame(payload: bytes, shape) -> bytes:
    h = json.dumps({"shape": list(shape), "dtype": "float32",
                    "nbytes": len(payload)}).encode()
    return _LEN.pack(len(h)) + h + payload


async def drive(p: dict, payloads, times, clips):
    """Send every request at its time from the start, each on a task of its
    own spawned at that time; returns what main() writes."""
    idle: list = []
    lat = [None] * len(times)
    late = np.zeros(len(times))
    errors: dict = {}  # refusals: the daemon's error replies, failed connects
    lost = [0]  # requests sent and never answered
    lo = {}
    hi = {}

    async def one(i, due):
        writer = None
        try:
            conn = idle.pop() if idle else await asyncio.open_unix_connection(p["socket"])
        except OSError as e:  # the daemon did not take the connection
            key = f"connect: {type(e).__name__}"
            errors[key] = errors.get(key, 0) + 1
            return
        try:
            reader, writer = conn
            writer.write(payloads[clips[i]])
            await writer.drain()
            header, body = await _read_msg(reader)
        except (OSError, asyncio.IncompleteReadError):
            lost[0] += 1
            if writer is not None:
                writer.close()
            return
        done = time.perf_counter()
        idle.append(conn)
        if "error" in header:
            key = str(header["error"])[:80]
            errors[key] = errors.get(key, 0) + 1
            return
        lat[i] = (done - due) * 1e3
        out = np.frombuffer(body, np.float32).reshape(header["shape"])
        c = int(clips[i])
        if c in lo:
            np.minimum(lo[c], out, out=lo[c])
            np.maximum(hi[c], out, out=hi[c])
        else:
            lo[c], hi[c] = out.copy(), out.copy()

    def finished(task):
        inflight.discard(task)
        if not task.cancelled() and task.exception() is not None:
            lost[0] += 1  # one() handles every reply; anything else is a fault
            print(f"loadgen: {task.exception()!r}", file=sys.stderr)

    go_at = time.perf_counter()
    inflight: set = set()
    for i, t in enumerate(times):
        due = go_at + float(t)
        delay = due - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        late[i] = (time.perf_counter() - due) * 1e3
        task = asyncio.ensure_future(one(i, due))
        inflight.add(task)
        task.add_done_callback(finished)
    end = go_at + float(times[-1]) + p.get("grace", 60.0)
    if inflight:
        _, pending = await asyncio.wait(set(inflight),
                                        timeout=max(1.0, end - time.perf_counter()))
        for t in pending:
            t.cancel()
        lost[0] += len(pending)
    for _, w in idle:
        w.close()
    return lat, late, errors, lost[0], lo, hi


def main(path: str) -> None:
    with open(path) as f:
        p = json.load(f)
    if "cpu" in p:
        os.sched_setaffinity(0, {p["cpu"]})
    bank = clip_bank(p["seed"], p["bank"], p["seq_len"], p["feature_dim"])
    payloads = [_frame(c.tobytes(), c.shape) for c in bank]
    times, clips = schedule(p["seed"], p["rate"], p["seconds"], p["bank"])
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        lat, late, errors, lost, lo, hi = asyncio.run(drive(p, payloads, times, clips))
    finally:
        gc.enable()
    q = np.quantile(late, [0.5, 0.95, 0.99, 1.0]).tolist()
    with open(p["out"], "w") as f:
        json.dump({"latency_ms": lat, "errors": errors, "lost": lost,
                   "late_ms": dict(zip(("p50", "p95", "p99", "max"), q)),
                   "clips": clips.tolist(), "envelope": {
                       str(c): [lo[c].tolist(), hi[c].tolist()] for c in lo}}, f)
    print("done", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
