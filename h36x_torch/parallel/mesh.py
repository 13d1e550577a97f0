"""The process layout (the data-axis part of h36x/parallel/mesh.py).

h36x builds a (slice, data, model) device mesh; `data` and `slice` both
split the batch. The port runs one process per device, so its mesh is a
description of the processes: data x slices must equal the number of
processes, and :func:`data_axis_size` is the number of ways the global
batch splits (:func:`h36x_torch.parallel.distributed.local_batch_slice`).
Tensor parallelism (`--mesh.model` > 1) and more devices than processes
come with a later slice and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from h36x_torch.parallel.distributed import LATER, process_info


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
    process group's size), one device each; data -1 uses every process.
    Raises ValueError for a layout that does not cover the processes and
    NotImplementedError for what a later slice ports."""
    n = process_info()[1] if n_processes is None else n_processes
    if model > 1:
        raise NotImplementedError(
            f"--mesh.model {model}: tensor parallelism {LATER}; leave --mesh.model 1")
    if model < 1 or slices < 1:
        raise ValueError(f"mesh model={model}, slices={slices} must be >= 1")
    if data == -1:
        if n % slices != 0:
            raise ValueError(f"{n} processes not divisible by slices={slices}")
        data = n // slices
    if data < 1:
        raise ValueError(f"--mesh.data {data} must be >= 1 (or -1)")
    if slices * data > n:
        raise NotImplementedError(
            f"mesh {slices}x{data}x{model} needs {slices * data} devices on {n} "
            f"process(es): more than one device per process {LATER}; run one "
            "process per device (--dist.num-processes)")
    if slices * data != n:
        raise ValueError(f"mesh {slices}x{data}x{model} != {n} devices "
                         "(one per process)")
    return Mesh(slices, data, model)


def data_axis_size(mesh: Mesh) -> int:
    """Number of ways the batch axis is split (slice * data)."""
    return mesh.shape["slice"] * mesh.shape["data"]
