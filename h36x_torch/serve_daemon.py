"""Dynamic-batching serving daemon for the PHD model (counterpart of
h36x/serve_daemon.py).

A small asyncio daemon accepts feature clips over TCP or a unix socket,
coalesces concurrent requests into one device batch (dynamic batching up to
`max_batch` with a `max_wait_ms` deadline), runs the forward once, and fans
the rows back out. The server, the wire protocol and the client are the JAX
daemon's, so clients of either daemon talk to both; only the model source
differs (:func:`build_predict_fn`): an artifact of h36x_torch.export
(batches padded to power-of-two buckets) or a checkpoint (the kernels,
batches at their exact size).

Wire protocol (both directions):
  8-byte big-endian header length | JSON header | raw payload bytes
  request header:  {"shape": [T, F], "dtype": "float32"}
  response header: {"shape": [T, J, 3], "dtype": "float32"} or {"error": m};
                   a rollout artifact replies [T + steps, J, 3] with
                   "split": T (context rows | forecast rows), which the
                   client splits back into (ctx, future)
  Observability: {"op": "stats"} (no payload) returns {"stats": {...}} —
  request/batch/row counts, uptime, queue depth, mean coalesced batch
  size, and p50/p90/p99 latency for the device call and for the full
  request (enqueue -> result). Unknown ops get the error envelope and the
  connection keeps serving.

`serve_forever` / `BatchingServer` are importable for embedding; the CLI
lives in h36x_torch/cli/serve.py.
"""

from __future__ import annotations

import asyncio
import json
import struct
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

_LEN = struct.Struct(">Q")
_MAX_HEADER = 1 << 16
_MAX_PAYLOAD = 1 << 30


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


async def _read_msg(reader: asyncio.StreamReader):
    raw = await reader.readexactly(_LEN.size)
    (hlen,) = _LEN.unpack(raw)
    if hlen > _MAX_HEADER:
        raise ValueError(f"header too large: {hlen}")
    header = json.loads(await reader.readexactly(hlen))
    payload = b""
    if not isinstance(header, dict):
        raise ValueError(f"header must be a JSON object, got {type(header).__name__}")
    nbytes = int(header.get("nbytes", 0))
    if nbytes:
        if nbytes < 0 or nbytes > _MAX_PAYLOAD:
            raise ValueError(f"bad payload size: {nbytes}")
        payload = await reader.readexactly(nbytes)
    return header, payload


def _write_msg(writer: asyncio.StreamWriter, header: dict,
               payload: bytes = b"") -> None:
    header = dict(header, nbytes=len(payload))
    hbytes = json.dumps(header).encode()
    writer.write(_LEN.pack(len(hbytes)) + hbytes + payload)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


def bucket_size(n: int) -> int:
    """Smallest power of two >= n (the batch-size buckets artifact mode
    pads to, bounding the number of distinct shapes it serves)."""
    return 1 << max(0, int(n) - 1).bit_length()


class BatchingServer:
    """Coalesce concurrent (T, F) requests into one (B, T, F) device call.

    predict_fn: (B, T, F) f32 numpy -> (B, T, J, 3) numpy-convertible, or a
    tuple of such arrays concatenated on time for the reply (a rollout's
    (ctx, future): the reply carries "split"). pad_to > 0 pads every batch
    to that many rows. pad_to == 0 with bucket_pad=True pads each batch up
    to the next power of two, clamped at max_batch (artifact mode: a few
    sizes, all warmed at startup). pad_to == 0 with bucket_pad=False runs
    batches at their exact size (checkpoint mode: PyTorch runs eagerly).

    max_queue bounds the request queue: past that depth new requests get
    an explicit "server overloaded" error instead of queueing without
    bound (0 disables the cap). `drain()` + stop() is the graceful
    shutdown pair serve_forever wires to SIGTERM.
    """

    def __init__(self, predict_fn: Callable, seq_len: int, feature_dim: int,
                 max_batch: int = 16, max_wait_ms: float = 5.0,
                 pad_to: int = 0, bucket_pad: bool = False,
                 max_queue: int = 1024):
        self.predict_fn = predict_fn
        self.seq_len = int(seq_len)
        self.feature_dim = int(feature_dim)
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1000.0
        self.pad_to = int(pad_to)
        self.bucket_pad = bool(bucket_pad)
        # backpressure bound: past this depth new requests are REJECTED
        # with an explicit overload error instead of queueing without
        # bound (each queued row pins a (T, F) f32 buffer — an unbounded
        # flood would grow host memory until the OOM killer wins)
        self.max_queue = int(max_queue)
        self._queue: asyncio.Queue = asyncio.Queue()
        self._batcher: Optional[asyncio.Task] = None
        self._closed = False
        # live client transports: shutdown must be able to close them, or
        # `async with srv` exit (Server.wait_closed, which on Python
        # >= 3.12.1 waits for every connection handler) hangs forever on a
        # single idle client whose handle() is parked in _read_msg
        self._writers: set = set()
        self._inflight = 0  # rows of the batch currently on the device
        self.stats = {"requests": 0, "batches": 0, "rows": 0, "rejected": 0}
        self._t_start: Optional[float] = None
        # bounded reservoirs: stats must never grow with daemon lifetime
        self._batch_ms: deque = deque(maxlen=1024)  # device-call wall ms
        self._batch_rows: deque = deque(maxlen=1024)  # real rows per batch
        self._req_ms: deque = deque(maxlen=4096)  # enqueue -> result ms

    # -- connection handler -------------------------------------------------

    async def handle(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                try:
                    header, payload = await _read_msg(reader)
                except asyncio.IncompleteReadError:
                    break
                except Exception as e:
                    # malformed framing/header (bad JSON, non-dict, negative
                    # nbytes): the stream may be desynced, so reply with the
                    # protocol's error envelope and close — never drop the
                    # connection with a bare reset + unretrieved-task warning
                    _write_msg(writer, {"error": f"bad request: {e}"})
                    await writer.drain()
                    break
                op = header.get("op")
                if op is not None:
                    _write_msg(writer, {"stats": self.stats_snapshot()}
                               if op == "stats"
                               else {"error": f"unknown op: {op!r}"})
                    await writer.drain()
                    continue
                try:
                    feats = self._parse(header, payload)
                except (ValueError, TypeError) as e:
                    _write_msg(writer, {"error": str(e)})
                    await writer.drain()
                    continue
                if self._closed:
                    _write_msg(writer, {"error": "server stopped"})
                    await writer.drain()
                    break
                if self.max_queue > 0 and self._queue.qsize() >= self.max_queue:
                    self.stats["rejected"] += 1
                    _write_msg(writer, {"error": (
                        f"server overloaded: {self._queue.qsize()} requests "
                        "queued (max_queue); retry with backoff")})
                    await writer.drain()
                    continue
                loop = asyncio.get_running_loop()
                fut: asyncio.Future = loop.create_future()
                self.stats["requests"] += 1
                # note: put on the unbounded queue never yields, so the
                # _closed check above cannot race stop()'s drain
                await self._queue.put((feats, fut, loop.time()))
                try:
                    joints, split = await fut
                except Exception as e:  # batch failed; report, keep serving
                    _write_msg(writer, {"error": f"inference failed: {e}"})
                    await writer.drain()
                    continue
                out = np.ascontiguousarray(joints, dtype=np.float32)
                header = {"shape": list(out.shape), "dtype": "float32"}
                if split is not None:  # rollout: ctx rows | forecast rows
                    header["split"] = split
                _write_msg(writer, header, out.tobytes())
                await writer.drain()
        finally:
            self._writers.discard(writer)
            writer.close()

    def _parse(self, header: dict, payload: bytes) -> np.ndarray:
        if "shape" not in header:
            raise ValueError("missing 'shape'")
        shape = tuple(int(s) for s in header["shape"])
        if len(shape) != 2 or shape != (self.seq_len, self.feature_dim):
            raise ValueError(
                f"expected shape [{self.seq_len}, {self.feature_dim}], "
                f"got {list(shape)}")
        if header.get("dtype", "float32") != "float32":
            raise ValueError("dtype must be float32")
        want = shape[0] * shape[1] * 4
        if len(payload) != want:
            raise ValueError(f"payload is {len(payload)} bytes, want {want}")
        return np.frombuffer(payload, np.float32).reshape(shape)

    # -- batcher ------------------------------------------------------------

    def _run_batch(self, feats: np.ndarray):
        """Device call (worker thread) -> (rows, split). A tuple output
        (a rollout's (ctx, future)) is concatenated on time into one array,
        split the context length, so one wire payload carries both."""
        out = self.predict_fn(feats)
        if isinstance(out, (tuple, list)):
            parts = [np.asarray(p) for p in out]
            return np.concatenate(parts, axis=1), int(parts[0].shape[1])
        return np.asarray(out), None

    async def _batch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            items = [await self._queue.get()]
            self._inflight = 1
            try:
                deadline = loop.time() + self.max_wait
                while len(items) < self.max_batch:
                    timeout = deadline - loop.time()
                    if timeout <= 0:
                        break
                    try:
                        items.append(
                            await asyncio.wait_for(self._queue.get(), timeout))
                    except asyncio.TimeoutError:
                        break
                # ANY failure in pad/predict/fan-out must fail this batch's
                # futures and keep the loop alive: an escaped exception kills
                # the batcher task silently (nothing awaits it) and every
                # later request would queue into a consumer-less queue
                self._inflight = len(items)
                try:
                    feats = np.stack([f for f, _, _ in items])
                    n = feats.shape[0]
                    # bucket padding clamps at max_batch: a non-power-of-two
                    # cap must not round past itself into an unwarmed,
                    # oversized shape
                    target = self.pad_to or (
                        min(bucket_size(n), self.max_batch) if self.bucket_pad
                        else n)
                    if n < target:
                        pad = np.zeros((target - n,) + feats.shape[1:],
                                       np.float32)
                        feats = np.concatenate([feats, pad])
                    # the device wait runs in a worker thread so the event
                    # loop keeps accepting (queueing) the next batch
                    t_dev = loop.time()
                    joints, split = await loop.run_in_executor(
                        None, self._run_batch, feats)
                    dev_ms = (loop.time() - t_dev) * 1e3
                    if joints.shape[0] != feats.shape[0]:
                        raise RuntimeError(
                            f"predict_fn returned {joints.shape[0]} rows "
                            f"for a batch of {feats.shape[0]}")
                    results = [(joints[i], split) for i in range(n)]
                except Exception as e:
                    for _, fut, _ in items:
                        if not fut.done():
                            fut.set_exception(RuntimeError(str(e)))
                    continue
                self.stats["batches"] += 1
                self.stats["rows"] += n
                self._batch_ms.append(dev_ms)
                self._batch_rows.append(n)
                now = loop.time()
                for (_, fut, t_enq), res in zip(items, results):
                    self._req_ms.append((now - t_enq) * 1e3)
                    if not fut.done():
                        fut.set_result(res)
            except asyncio.CancelledError:
                # stop() cancelled us mid-batch: these items are already out
                # of the queue, so stop()'s drain cannot reach them — fail
                # them here or their clients hang on `await fut` forever
                for _, fut, _ in items:
                    if not fut.done():
                        fut.set_exception(RuntimeError("server stopped"))
                raise
            finally:
                self._inflight = 0

    async def drain(self, timeout_s: float = 10.0) -> bool:
        """Wait (bounded) for queued + in-flight work to finish — the
        graceful half of shutdown. Close the listener first so nothing new
        arrives; returns True when fully drained, False on deadline."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while self._queue.qsize() or self._inflight:
            if loop.time() >= deadline:
                return False
            await asyncio.sleep(0.05)
        return True

    # -- observability ------------------------------------------------------

    def stats_snapshot(self) -> dict:
        """JSON-safe operational stats — the `{"op": "stats"}` reply.

        Latency percentiles come from bounded reservoirs (last 1024
        batches / 4096 requests), so a long-lived daemon reports recent
        behavior, not its lifetime average, at O(1) memory.
        """

        def pct(samples) -> Optional[dict]:
            if not samples:
                return None
            xs = np.sort(np.asarray(samples, np.float64))
            at = lambda q: round(float(xs[min(len(xs) - 1, int(q * len(xs)))]), 3)  # noqa: E731
            return {"p50": at(0.50), "p90": at(0.90), "p99": at(0.99),
                    "max": round(float(xs[-1]), 3), "n": int(len(xs))}

        batches = self.stats["batches"]
        return {
            **self.stats,
            "uptime_s": (None if self._t_start is None
                         else round(time.monotonic() - self._t_start, 3)),
            "queue_depth": self._queue.qsize(),
            "mean_batch_rows": (round(self.stats["rows"] / batches, 3)
                                if batches else None),
            "batch_device_ms": pct(self._batch_ms),
            "request_ms": pct(self._req_ms),
        }

    # -- lifecycle ----------------------------------------------------------

    async def start(self, host: Optional[str] = None,
                    port: Optional[int] = None,
                    unix_path: Optional[str] = None):
        self._t_start = time.monotonic()
        self._batcher = asyncio.ensure_future(self._batch_loop())
        if unix_path:
            import os

            try:  # a stale socket from an unclean shutdown blocks rebinding
                os.unlink(unix_path)
            except FileNotFoundError:
                pass
            return await asyncio.start_unix_server(self.handle, path=unix_path)
        return await asyncio.start_server(self.handle, host=host, port=port)

    def stop(self) -> None:
        # flag first: handle() checks it before enqueuing, so no request
        # can slip into the queue after the drain below
        self._closed = True
        if self._batcher is not None:
            self._batcher.cancel()
            self._batcher = None
        # fail queued requests instead of leaving their clients waiting
        while not self._queue.empty():
            _, fut, _ = self._queue.get_nowait()
            if not fut.done():
                fut.set_exception(RuntimeError("server stopped"))


# ---------------------------------------------------------------------------
# Client (tests, smoke checks, simple integrations)
# ---------------------------------------------------------------------------


async def request_async(feats: np.ndarray, host: Optional[str] = None,
                        port: Optional[int] = None,
                        unix_path: Optional[str] = None,
                        timeout_s: Optional[float] = None):
    """One (T, F) request -> (T, J, 3) prediction, or (ctx, future) from a
    daemon serving a rollout artifact (the reply's "split").

    timeout_s bounds the WHOLE round trip (connect + upload + inference +
    download); a hung daemon then raises asyncio.TimeoutError instead of
    hanging the client forever. None (default) preserves unbounded waits.
    """
    if timeout_s is not None:
        return await asyncio.wait_for(
            request_async(feats, host=host, port=port, unix_path=unix_path),
            timeout_s)
    if unix_path:
        reader, writer = await asyncio.open_unix_connection(unix_path)
    else:
        reader, writer = await asyncio.open_connection(host, port)
    try:
        feats = np.ascontiguousarray(feats, np.float32)
        _write_msg(writer, {"shape": list(feats.shape), "dtype": "float32"},
                   feats.tobytes())
        await writer.drain()
        header, payload = await _read_msg(reader)
    finally:
        writer.close()
    if "error" in header:
        raise RuntimeError(header["error"])
    out = np.frombuffer(payload, np.float32).reshape(header["shape"])
    split = header.get("split")
    if split is not None:
        return out[:split], out[split:]
    return out


def request(feats: np.ndarray, **kw):
    return asyncio.run(request_async(feats, **kw))


async def stats_async(host: Optional[str] = None, port: Optional[int] = None,
                      unix_path: Optional[str] = None,
                      timeout_s: Optional[float] = None) -> dict:
    """Query a running daemon's operational stats (`{"op": "stats"}`).

    timeout_s bounds the whole round trip — a wedged daemon (blocked event
    loop, half-open connection) must not hang the diagnostic tool that
    exists to diagnose it. None preserves unbounded waits (embedders that
    manage their own deadlines)."""
    if timeout_s is not None:
        return await asyncio.wait_for(
            stats_async(host=host, port=port, unix_path=unix_path),
            timeout_s)
    if unix_path:
        reader, writer = await asyncio.open_unix_connection(unix_path)
    else:
        reader, writer = await asyncio.open_connection(host, port)
    try:
        _write_msg(writer, {"op": "stats"})
        await writer.drain()
        header, _ = await _read_msg(reader)
    finally:
        writer.close()
    if "error" in header:
        raise RuntimeError(header["error"])
    return header["stats"]


def get_stats(**kw) -> dict:
    return asyncio.run(stats_async(**kw))


# ---------------------------------------------------------------------------
# Model loading
# ---------------------------------------------------------------------------


def build_predict_fn(artifact: str = "", model_path: str = "",
                     seq_len: int = 40, feature_dim: int = 2048,
                     latent_dim: int = 1024, num_blocks: int = 2,
                     max_batch: int = 16, warm: bool = False,
                     regressor_iters: int = 3, groups: int = 32,
                     ar_blocks: int = 3, kernel_size: int = 3,
                     regressor_hidden: int = 1024, joints_num: int = 17,
                     device=None, precise: bool = False):
    """Returns (predict_fn, pad_to) from an artifact or a checkpoint, on
    `device` (cuda unless the caller asks for another).

    Artifact mode loads an h36x_torch.export artifact (its architecture,
    dtype and window baked in; the model arguments and seq_len/feature_dim
    are not read) onto the device. A symbolic batch serves every size: it
    returns pad_to=0, to pair with bucket_pad=True, and warm=True runs every
    power-of-two bucket up to max_batch (and max_batch itself) once at
    startup, so the first request of a size pays no first-call cost. A
    fixed batch (export's `batch=`) serves that size only: it returns
    pad_to=that batch (every batch padded to it), refuses a max_batch above
    it with ValueError, and warm=True runs that size. A rollout artifact's
    predict_fn returns (ctx, future).

    Checkpoint mode loads the params (held against the model's shapes) and
    serves :func:`h36x_torch.infer.make_fused_forward` with the kernels on,
    at `precise` (False, the serving default: bfloat16 weights and
    activations as bfloat16 pairs with float32 sums, the bfloat16 weight
    copies made once by the engine). It returns pad_to=0 for
    bucket_pad=False: PyTorch runs each batch eagerly at its own size.
    warm=True runs one max_batch forward at startup.

    Every forward runs on one dedicated device thread: the kernels' first
    build and load, and the per-thread CUDA and cuBLAS set-up, are paid by
    the warm-up on that thread instead of inside the first request.
    """
    import torch

    from h36x_torch.utils.runtime import resolve_device

    device = resolve_device(device)
    if artifact:
        from h36x_torch.export import load_artifact

        forward = load_artifact(artifact, device=device)
        fixed, seq_len, feature_dim = forward.input_shape
        if fixed is None:
            pad_to = 0
            warm_sizes = sorted({1 << i for i in range(max(1, max_batch).bit_length())
                                 if 1 << i < max_batch} | {max_batch})
        elif max_batch > fixed:
            raise ValueError(
                f"max_batch {max_batch} exceeds the artifact's fixed batch "
                f"{fixed}: serve it with max_batch <= {fixed}, or export "
                "without --batch (a symbolic batch)")
        else:
            pad_to, warm_sizes = fixed, [fixed]
    else:
        from h36x_torch.cli.common import build_model_from_arch
        from h36x_torch.infer import make_fused_forward
        from h36x_torch.models.phd import param_tree
        from h36x_torch.train import checkpoint as ckpt

        model = build_model_from_arch(dict(
            latent_dim=latent_dim, feature_dim=feature_dim, joints_num=joints_num,
            num_blocks=num_blocks, ar_num_blocks=ar_blocks, groups=groups,
            kernel_size=kernel_size, regressor_iters=regressor_iters,
            regressor_hidden=regressor_hidden), device="cpu")
        model.load_state_dict(ckpt.load_params_only(model_path, model.state_dict()))
        model.to(device)
        forward = make_fused_forward(param_tree(model), joints_num=joints_num,
                                     groups=groups, use_kernels=True,
                                     regressor_iters=regressor_iters,
                                     precise=precise)
        pad_to, warm_sizes = 0, [max_batch]

    device_thread = ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix="h36x-device")

    def run(feats):
        x = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(device)
        out = forward(x)
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()

    def predict(feats):
        return device_thread.submit(run, feats).result()

    if warm:
        for b in warm_sizes:
            predict(np.zeros((b, seq_len, feature_dim), np.float32))
    return predict, pad_to


async def serve_forever(server: BatchingServer, drain_s: float = 10.0,
                        **bind_kw) -> None:
    """Run until the listener dies or SIGTERM/SIGINT arrives; on a signal,
    shut down gracefully: stop accepting, let queued + in-flight batches
    finish (bounded by drain_s), flush replies, then stop the batcher —
    so a rolling restart does not fail the requests already accepted."""
    import signal

    srv = await server.start(**bind_kw)
    addrs = ", ".join(str(s.getsockname()) for s in srv.sockets)
    print(f"h36x_torch serve listening on {addrs}", flush=True)
    loop = asyncio.get_running_loop()
    stop_ev = asyncio.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop_ev.set)
        except (NotImplementedError, ValueError, RuntimeError):
            pass  # non-main thread / platform without loop signal support
    async with srv:
        serve_task = asyncio.ensure_future(srv.serve_forever())
        stop_task = asyncio.ensure_future(stop_ev.wait())
        done, _ = await asyncio.wait({serve_task, stop_task},
                                     return_when=asyncio.FIRST_COMPLETED)
        stop_task.cancel()
        if serve_task in done:
            return await serve_task  # listener failed on its own: surface it
        print("h36x_torch serve: shutdown signal — draining...", flush=True)
        srv.close()  # no new connections; existing ones may still finish
        serve_task.cancel()
        drained = await server.drain(drain_s)
        await asyncio.sleep(0.1)  # let handle() coroutines write replies out
        server.stop()
        # close surviving client transports (idle keep-alive connections):
        # their handle() coroutines are parked in _read_msg, and on Python
        # >= 3.12.1 the `async with srv` exit below waits for every handler
        # to return — one idle client would otherwise wedge the shutdown
        # until SIGKILL. Closing wakes _read_msg with EOF; replies already
        # written are flushed by the transport before teardown.
        for w in list(server._writers):
            w.close()
        print(f"h36x_torch serve: {'drained' if drained else 'DRAIN TIMEOUT'}; "
              f"served {server.stats['requests']} requests "
              f"({server.stats['rejected']} rejected)", flush=True)
