"""The device mesh and h36x's sharding rules (counterpart of
h36x/parallel/mesh.py).

h36x builds a (slice, data, model) device mesh; `data` and `slice` both
split the batch, `model` splits the wide layers (tensor parallelism). The
port's :class:`Mesh` holds the same array of devices, in h36x's row-major
order over the global device list: process 0's local devices first, then
process 1's, and so on (`jax.devices()`'s order), so the device of
process p, local index l is global device p x L + l (L devices per
process), at mesh coordinates (slice, data, model) of that index.

A device may appear more than once (a virtual device: `cpu` named N times
under `--dist.local-devices N`, or `cuda:0` named twice on one card), the
counterpart of XLA's forced host devices. Each entry is a
:class:`MeshDevice` (process, local index, torch.device; the device is
None in the entries of other processes, which this process cannot name).

:func:`data_axis_size` is the number of ways the global batch splits. A
model axis lies inside one process (L divisible by `model`: the process's
devices run the split products, :mod:`h36x_torch.parallel.tensor`) or
spans processes of one device each (process groups,
:mod:`h36x_torch.parallel.distributed`); a model axis over several
processes of several devices each raises (:meth:`Mesh.local_groups`).

The sharding rules are h36x's `_TP_RULES`, matched on the same
'/'-joined flax paths ('f_movie/block0/conv1/kernel'): for each param the
dimension that splits over `model`, or None (replicated). A dimension
that the model axis does not divide stays replicated, with h36x's WARNING
printed once. :func:`shard_params` takes one model index's slice.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from h36x_torch.parallel.distributed import model_info, process_devices, process_info


class MeshDevice(NamedTuple):
    """One entry of a mesh's device array."""
    process: int
    index: int  # local index on its process
    device: Optional[torch.device]  # None on another process's entry


@dataclass(frozen=True)
class Mesh:
    """A (slice, data, model) mesh. `devices`, the (slices, data, model)
    array of :class:`MeshDevice`, is None for a layout alone (the sharding
    rules read only the axis sizes)."""
    slices: int
    data: int
    model: int
    devices: Optional[np.ndarray] = field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return {"slice": self.slices, "data": self.data, "model": self.model}

    @property
    def local_count(self) -> int:
        """Devices per process."""
        flat = self.devices.reshape(-1)
        return sum(1 for d in flat if d.process == flat[0].process)

    def local_groups(self, rank: Optional[int] = None) -> List[List[torch.device]]:
        """This process's devices by batch-axis row (slice x data index), in
        row order, each row's devices in model order: one list per local
        data replica, each of the local model axis's length (1 where the
        model axis spans processes). Raises NotImplementedError for a model
        axis over several processes of several devices each."""
        rank = process_info()[0] if rank is None else rank
        groups = []
        for row in self.devices.reshape(-1, self.model):
            own = [d.device for d in row if d.process == rank]
            if own and len(own) != len(row) and len(own) > 1:
                raise NotImplementedError(
                    f"a model axis of {self.model} over processes of "
                    f"{self.local_count} devices each; the model axis must lie "
                    "inside one process or span processes of one device each")
            if own:
                groups.append(own)
        return groups


def global_devices(local: Sequence, n_processes: Optional[int] = None,
                   rank: Optional[int] = None) -> List[MeshDevice]:
    """The global device list of `n_processes` processes (default: the
    process group's size) of len(`local`) devices each, process by
    process; this process's entries carry its `local` devices."""
    r, n = process_info()
    n = n if n_processes is None else n_processes
    r = r if rank is None else rank
    return [MeshDevice(p, i, torch.device(d) if p == r and d is not None else None)
            for p in range(n) for i, d in enumerate(local)]


def make_mesh(data: int = -1, model: int = 1, devices=None, *, slices: int = 1,
              n_processes: Optional[int] = None) -> Mesh:
    """A (slice, data, model) mesh over `devices` (h36x's signature;
    `slices` > 1 is h36x's `make_multislice_mesh`); data -1 uses every
    device left: devices / (slices x model).

    `devices`: a list of :class:`MeshDevice` (a global list); or of
    torch devices (or names), which are this process's local devices,
    repeated over the processes; default: this process's devices as
    :func:`h36x_torch.parallel.distributed.setup_from_config` set them (one
    device each otherwise) over `n_processes` processes (default: the
    process group's size). Raises ValueError for a layout that does not
    cover the devices, with h36x's messages."""
    if devices is None:
        devices = global_devices(process_devices(), n_processes)
    elif not all(isinstance(d, MeshDevice) for d in devices):
        devices = global_devices(list(devices), n_processes)
    devices = list(devices)
    n = len(devices)
    if model < 1 or slices < 1:
        raise ValueError(f"mesh model={model}, slices={slices} must be >= 1")
    if data == -1:
        if n % (slices * model) != 0:
            what = f"model={model}" if slices == 1 else f"slices*model={slices * model}"
            raise ValueError(f"{n} devices not divisible by {what}")
        data = n // (slices * model)
    if data < 1:
        raise ValueError(f"--mesh.data {data} must be >= 1 (or -1)")
    if slices * data * model != n:
        dims = f"{data}x{model}" if slices == 1 else f"{slices}x{data}x{model}"
        raise ValueError(f"mesh {dims} != {n} devices")
    per = [sum(1 for d in devices if d.process == p) for p in {d.process for d in devices}]
    if len(set(per)) != 1:
        raise ValueError(f"every process must hold as many mesh devices: {per}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(slices, data, model, arr.reshape(slices, data, model))


def data_axis_size(mesh: Mesh) -> int:
    """Number of ways the batch axis is split (slice * data)."""
    return mesh.shape["slice"] * mesh.shape["data"]


def batch_sharding(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes a batch's leading dimension splits over: ("data",), or
    ("slice", "data") on a multislice mesh (h36x's PartitionSpec). Each
    process reads its block of rows
    (:func:`h36x_torch.parallel.distributed.local_batch_slice`)."""
    return ("slice", "data") if mesh.slices > 1 else ("data",)


# Param-path -> the dimension split over `model` (h36x's _TP_RULES: a
# PartitionSpec with "model" at that position). Paths are '/'-joined flax
# param paths, e.g. 'f_movie/block0/conv1/kernel'.
_TP_RULES: Tuple[Tuple[str, int], ...] = (
    # input projection (feature_dim x latent): split latent columns
    (r".*input_proj/kernel$", 1),
    (r".*input_proj/bias$", 0),
    # causal conv kernels (K, D_in, D_out): split output channels
    (r".*conv\d/kernel$", 2),
    (r".*conv\d/bias$", 0),
    # regressor MLP: fc1 splits hidden columns, fc2 contracts over those
    # rows (its partial sums are all-reduced), fc3 stays replicated
    (r".*f_3D/fc1/kernel$", 1),
    (r".*f_3D/fc1/bias$", 0),
    (r".*f_3D/fc2/kernel$", 0),
)

_warned_indivisible: set = set()


def param_sharding_rules(path: str, leaf, mesh: Mesh) -> Optional[int]:
    """The dimension of param `path` (shape `leaf.shape`) that splits over
    the model axis; None (replicated) unless a TP rule matches and the
    dimension divides the model axis's size."""
    model_size = mesh.shape["model"]
    if model_size > 1:
        for pattern, dim in _TP_RULES:
            if re.match(pattern, path):
                if tuple(leaf.shape)[dim] % model_size == 0:
                    return dim
                # an explicitly requested model axis that ends up fully
                # replicated is all-cost-no-benefit — say so
                key = (path, model_size)
                if key not in _warned_indivisible:
                    _warned_indivisible.add(key)
                    print(
                        f"WARNING: TP rule for {path} skipped — shape "
                        f"{tuple(leaf.shape)} not divisible by "
                        f"mesh.model={model_size}; this param stays "
                        "replicated (pick a model-axis size dividing the "
                        "layer widths)")
    return None


def _paths(tree, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _paths(value, path + "/")
        else:
            yield path, value


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def param_shardings(params, mesh: Mesh) -> dict:
    """A tree like `params` (flax layout) of the split dimension of each
    param (None: replicated)."""
    return _nest({path: param_sharding_rules(path, leaf, mesh)
                  for path, leaf in _paths(params)})


def shard_params(params, mesh: Mesh, index: Optional[int] = None) -> dict:
    """A tree like `params` of each param's slice for model index `index`
    (default: this process's): the index-th of `model` equal blocks along
    its split dimension, or the whole param where it is replicated."""
    m = mesh.shape["model"]
    index = model_info()[0] if index is None else index
    out = {}
    for path, leaf in _paths(params):
        dim = param_sharding_rules(path, leaf, mesh)
        if dim is None:
            out[path] = leaf
        else:
            n = leaf.shape[dim] // m
            out[path] = leaf[(slice(None),) * dim + (slice(index * n, (index + 1) * n),)]
    return _nest(out)
