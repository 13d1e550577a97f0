"""In-process collectives over a process's local devices: the counterpart
of what XLA does for h36x over the devices of one process (a batch
sharded over `data`, params replicated, the gradient's psum).

A process of a mesh (:meth:`h36x_torch.parallel.mesh.Mesh.local_groups`)
holds one or more local data replicas, each a list of devices along the
model axis. Here:

- :func:`split_rows` / :func:`merge_rows`: a batch's rows padded to the
  data axis and split into equal blocks, one per replica, each moved to its
  device; the blocks' outputs concatenated back in order, `[:n]`;
- :class:`Replicas`: a model's replicas, made once. Replica 0 is the model
  itself; a replica on the same device as the model holds the model's own
  parameter storage (its own `.grad`), one on another device a copy,
  refreshed when the model's parameters changed (their version counters),
  so an update made once reaches every replica, bit for bit;
- the mean of the replicas' gradient buffers is
  :func:`h36x_torch.parallel.distributed.mean_across_processes`' first
  stage; :func:`running` tells :func:`h36x_torch.infer.dropout_mask`
  which block of the process's rows a replica runs, so its masks are the
  global batch's.

Every replica is queued from one thread, device by device: on distinct
cards the kernels of different replicas overlap without Python threads;
the devices of a virtual list (one card named twice) run them in turn.
"""

from __future__ import annotations

import contextlib
import copy
from typing import List, Optional, Sequence

import numpy as np
import torch

_position = (0, 1)  # (local data replica running now, local replica count)


@contextlib.contextmanager
def running(index: int, count: int):
    """Within it, :func:`replica_position` is (index, count): the
    dropout masks drawn there are replica `index`'s block of rows."""
    global _position
    before, _position = _position, (index, count)
    try:
        yield
    finally:
        _position = before


def replica_position():
    """(the local data replica running now, the process's replica count);
    (0, 1) outside :func:`running`."""
    return _position


def same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def to_device(x, device):
    """`x` on `device` (a numpy array through pinned memory on CUDA; a
    tensor already there as it is)."""
    if isinstance(x, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if torch.device(device).type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return x if same_device(x.device, device) else x.to(device)


def pad_rows(x, parts: int):
    """`x` (numpy or tensor) with zero rows appended up to a multiple of
    `parts` (h36x's padded tail)."""
    n = x.shape[0]
    short = -n % parts
    if not short:
        return x
    if isinstance(x, np.ndarray):
        return np.concatenate([x, np.zeros((short,) + x.shape[1:], x.dtype)])
    return torch.cat([x, x.new_zeros((short,) + tuple(x.shape[1:]))])


def split_rows(x, devices: Sequence) -> list:
    """`x`'s rows (a multiple of len(devices)) in len(devices) equal
    blocks, block i on devices[i]."""
    parts = len(devices)
    if x.shape[0] % parts:
        raise ValueError(f"{x.shape[0]} rows do not split {parts} ways (pad_rows first)")
    rows = x.shape[0] // parts
    return [to_device(x[i * rows:(i + 1) * rows], d) for i, d in enumerate(devices)]


def merge_rows(blocks: Sequence[torch.Tensor], n: Optional[int] = None,
               device=None) -> torch.Tensor:
    """The blocks' rows in order on `device` (default the first block's),
    the first `n` of them."""
    device = blocks[0].device if device is None else device
    out = torch.cat([to_device(b, device) for b in blocks])
    return out if n is None else out[:n]


_generators: dict = {}  # device -> a generator of it, for replicas on other devices


def generator_at(generator: torch.Generator, device, state) -> torch.Generator:
    """A generator on `device` in `state` (a state of `generator`):
    `generator` itself where it lives on `device`, else one generator per
    device, made once. Replicas drawing from one state draw the global
    batch's masks alike (:func:`h36x_torch.infer.dropout_mask`)."""
    if same_device(generator.device, device):
        generator.set_state(state)
        return generator
    key = str(torch.device(device))
    if key not in _generators:
        _generators[key] = torch.Generator(device=device)
    _generators[key].set_state(state)
    return _generators[key]


def on_replicas(replicas: "Replicas", fn, feats):
    """fn(model, rows) over the replicas, each on its block of `feats`'
    rows (a tensor or a host array, padded to the replica count), the
    outputs (a tensor or a tuple of tensors and None) merged back in order,
    `[:n]`, on `feats`' device (a host array's: the first replica's)."""
    n = feats.shape[0]
    firsts = [g[0] for g in replicas.groups]
    home = feats.device if isinstance(feats, torch.Tensor) else firsts[0]
    blocks = split_rows(pad_rows(feats, replicas.count), firsts)
    outs = []
    for r, (m, x) in enumerate(zip(replicas.models, blocks)):
        with running(r, replicas.count):
            outs.append(fn(m, x))
    if isinstance(outs[0], torch.Tensor):
        return merge_rows(outs, n, home)
    return tuple(None if o[0] is None else merge_rows(o, n, home) for o in zip(*outs))


def replica_of(model, devices):
    """A model of `model`'s architecture on `devices[0]` (its model-axis
    split, if any, over `devices`) whose parameters and buffers are
    `model`'s: the same storage on the same device (each parameter its own
    `.grad`), else copies."""
    dev = devices[0]

    def place(t):
        return t.detach() if same_device(dev, t.device) else t.detach().to(dev, copy=True)

    memo = {id(p): torch.nn.Parameter(place(p), requires_grad=p.requires_grad)
            for p in model.parameters()}
    memo.update((id(b), place(b)) for b in model.buffers())
    tp = getattr(model, "tp", None)  # the PHD model's tensor-parallel split
    memo[id(tp)] = None
    replica = copy.deepcopy(model, memo)
    if tp is not None:
        replica.tp = tp.on(devices)
    return replica


def _versions(model) -> tuple:
    return tuple(p._version for p in model.parameters())


class Replicas:
    """`model`'s replicas over a process's local data axis: `groups[r]` are
    replica r's devices along the model axis (the first holds its
    parameters; more than one: the model axis inside the process,
    :class:`h36x_torch.parallel.tensor.LocalTensorParallel`).

    `grads`: the replicas get their own `.grad` (training); without, a
    replica on the model's device is the model itself."""

    def __init__(self, model, groups: Sequence[Sequence[torch.device]],
                 grads: bool = True):
        self.groups = [list(g) for g in groups]
        self.model = model
        self.models = [model] + [replica_of(model, g) if grads or not same_device(
            g[0], self.device) else model for g in self.groups[1:]]
        self._synced = [_versions(model)] * len(self.models)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def count(self) -> int:
        return len(self.models)

    def sync(self) -> None:
        """Copy the model's parameters into the replicas that hold copies,
        where they changed since the last sync; carry `requires_grad`."""
        now = _versions(self.model)
        for r, m in enumerate(self.models[1:], 1):
            if m is self.model:
                continue
            with torch.no_grad():
                for p, q in zip(self.model.parameters(), m.parameters()):
                    q.requires_grad_(p.requires_grad)
                    if self._synced[r] != now and q.data_ptr() != p.data_ptr():
                        q.copy_(p)
            self._synced[r] = now

    def split(self, batch) -> List[tuple]:
        """A batch's tensors split by rows, one block per replica on its
        device: replica r gets rows [r * B / count, (r + 1) * B / count)."""
        firsts = [g[0] for g in self.groups]
        return list(zip(*(split_rows(t, firsts) for t in batch)))
