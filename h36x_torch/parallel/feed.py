"""Host -> device feeding with a background producer (counterpart of
h36x/parallel/feed.py).

A thread turns host (numpy) batches into device tensors while the device
computes: the features are cast to the feed dtype on the side of the link
where they are narrower (fewer bytes over it; a bfloat16 store, held as
its bits, reaches a float32 feed without a float32 copy on the host), every
array goes to pinned memory and is copied with `non_blocking=True`. A
bounded queue keeps `buffer_size` batches ahead.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

import torch

from h36x_torch.data.shards import as_tensor

FEED_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}


def feed_dtype(name: str) -> torch.dtype:
    if name not in FEED_DTYPES:
        raise ValueError(f"feed_dtype must be float32|bfloat16|float16, got {name!r}")
    return FEED_DTYPES[name]


def to_device(batch, device: torch.device, feats_dtype: Optional[torch.dtype] = None):
    """A host batch (tuple of numpy arrays, features first; bfloat16 features
    as their uint16 bits) as device tensors, the features in `feats_dtype`:
    cast before the copy when that narrows them, after it otherwise."""
    out = []
    for i, arr in enumerate(batch):
        t = as_tensor(arr)
        cast = i == 0 and feats_dtype is not None and t.dtype != feats_dtype
        if cast and feats_dtype.itemsize < t.dtype.itemsize:
            t, cast = t.to(feats_dtype), False
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t.to(feats_dtype) if cast else t)
    return tuple(out)


def prefetch_to_device(batch_iter: Iterable, device: torch.device,
                       buffer_size: int = 2,
                       feats_dtype: Optional[torch.dtype] = None) -> Iterator:
    """Iterate device-resident batches, overlapping host work with compute.
    Errors of the producer are raised to the consumer; a consumer that stops
    early releases the producer."""
    if buffer_size <= 0:
        # queue.Queue(maxsize=0) is unbounded: the producer would race the
        # whole epoch onto the device
        raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    sentinel = object()
    err_box = []
    abandoned = threading.Event()

    def _put(item) -> bool:
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in batch_iter:
                if not _put(to_device(batch, device, feats_dtype)):
                    return
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            err_box.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err_box:
                    raise err_box[0]
                return
            yield item
    finally:
        abandoned.set()
        t.join(timeout=10)
