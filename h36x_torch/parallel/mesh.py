"""The process mesh and h36x's sharding rules (counterpart of
h36x/parallel/mesh.py).

h36x builds a (slice, data, model) device mesh; `data` and `slice` both
split the batch, `model` splits the wide layers (tensor parallelism). The
port runs one process per device, so its mesh is a description of the
processes: slices x data x model must equal the number of processes, rank
(slice x data + data index) x model + model index
(:mod:`h36x_torch.parallel.distributed`), and :func:`data_axis_size` is the
number of ways the global batch splits. More devices than processes (a
single-process multi-device mesh) raises.

The sharding rules are h36x's `_TP_RULES`, matched on the same
'/'-joined flax paths ('f_movie/block0/conv1/kernel'): for each param the
dimension that splits over `model`, or None (replicated). A dimension
that the model axis does not divide stays replicated, with h36x's WARNING
printed once. :func:`shard_params` takes each process's slice;
:mod:`h36x_torch.parallel.tensor` runs the model on those slices.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Tuple

from h36x_torch.parallel.distributed import LATER, model_info, process_info


@dataclass(frozen=True)
class Mesh:
    slices: int
    data: int
    model: int

    @property
    def shape(self) -> dict:
        return {"slice": self.slices, "data": self.data, "model": self.model}


def make_mesh(data: int = -1, model: int = 1, slices: int = 1,
              n_processes: Optional[int] = None) -> Mesh:
    """The (slice, data, model) layout over `n_processes` (default: the
    process group's size), one device each; data -1 uses every process
    left: processes / (slices x model). Raises ValueError for a layout
    that does not cover the processes and NotImplementedError for one that
    needs more devices than processes."""
    n = process_info()[1] if n_processes is None else n_processes
    if model < 1 or slices < 1:
        raise ValueError(f"mesh model={model}, slices={slices} must be >= 1")
    if data == -1:
        if n % (slices * model) != 0:
            what = f"slices={slices}" if model == 1 else f"slices*model={slices * model}"
            raise ValueError(f"{n} processes not divisible by {what}")
        data = n // (slices * model)
    if data < 1:
        raise ValueError(f"--mesh.data {data} must be >= 1 (or -1)")
    if slices * data * model > n:
        raise NotImplementedError(
            f"mesh {slices}x{data}x{model} needs {slices * data * model} devices on "
            f"{n} process(es): more than one device per process {LATER}; run one "
            "process per device (--dist.num-processes)")
    if slices * data * model != n:
        raise ValueError(f"mesh {slices}x{data}x{model} != {n} devices "
                         "(one per process)")
    return Mesh(slices, data, model)


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
