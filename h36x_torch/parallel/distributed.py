"""Multi-process parallelism on torch.distributed (counterpart of
h36x/parallel/distributed.py): every process runs the same CLI with its
own `--dist.process-id` and drives its local devices (one card per process
on CUDA; `--dist.local-devices N` virtual devices on the CPU, h36x's
`jax_num_cpu_devices`).

The processes' devices form h36x's (slice, data, model) mesh
(:func:`h36x_torch.parallel.mesh.make_mesh`): global device p x L + l for
process p's local device l, in the row-major order of h36x's
`np.array(devices).reshape(slices, data, model)`. A model axis spans
processes only when each holds one device: then rank = (slice index x data
+ data index) x model + model index, and :func:`init_groups` makes a
process group for each `model` axis (the ranks that hold the shards of one
set of params, :mod:`h36x_torch.parallel.tensor`) and each data axis (the
ranks that split the batch). Otherwise the model axis lies inside each
process and the processes are the data axis's blocks, in rank order.

Each data index walks the same seeded sampler order and gathers only its
:func:`local_batch_slice` rows of every global batch (every rank of one
model group the same rows), which its local data replicas split again
(:mod:`h36x_torch.parallel.local`); the trainer averages the gradients
(and the step's metrics) over the whole data axis, local replicas first,
then the processes with one flat all-reduce per update
(:func:`mean_across_processes`), and sums the eval's per-batch sums over
the processes, so the updates and the logged means are those of the
global batch. Rank 0 alone prints, writes metrics.jsonl and checkpoints.

Collectives: NCCL on CUDA, gloo on the CPU; `--dist.collectives gloo`
forces gloo on CUDA too (gloo reduces CUDA tensors through the host). NCCL
refuses two ranks on one device, so with NCCL chosen :func:`setup_from_config`
checks that every rank drives its own card and raises otherwise; it never
switches to gloo by itself.
"""

from __future__ import annotations

import os
import socket
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from h36x_torch.utils.runtime import local_devices, resolve_device

# this process's devices (setup_from_config); None: one device, unnamed
_process_devices: Optional[List[torch.device]] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "gloo") -> None:
    """Join the process group. `coordinator_address` is process 0's
    host:port (the rendezvous; empty: MASTER_ADDR / MASTER_PORT).
    num_processes None reads WORLD_SIZE and RANK from the environment (a
    launcher's); num_processes <= 1 is a no-op."""
    if num_processes is None:
        dist.init_process_group(backend, init_method="env://")
        return
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)


def process_info() -> Tuple[int, int]:
    """(this process's rank, the number of processes); (0, 1) outside a
    process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    """True on the process that logs and writes files (rank 0)."""
    return process_info()[0] == 0


class _Groups:
    """The mesh's axes as process groups (:func:`init_groups`): a model
    axis of `size` processes (one device each)."""

    def __init__(self, rank: int, world: int, size: int):
        self.model_index, self.model_size = rank % size, size
        self.data_index, self.data_size = rank // size, world // size
        # every rank makes every group, in one order (torch.distributed's rule)
        self.model_group = self.data_group = None
        for first in range(0, world, size):
            g = dist.new_group(list(range(first, first + size)))
            if first == self.data_index * size:
                self.model_group = g
        for mi in range(size):
            g = dist.new_group(list(range(mi, world, size)))
            if mi == self.model_index:
                self.data_group = g


_groups: Optional[_Groups] = None


def init_groups(mesh) -> None:
    """Make the process groups of `mesh`'s model and data axes (every rank
    calls it, after :func:`initialize`). A model axis inside each process,
    or none, makes no group: the data axis's processes are all of them. A
    model axis over processes of several devices each raises
    NotImplementedError."""
    global _groups
    rank, world = process_info()
    local = 1 if mesh.devices is None else mesh.local_count
    if mesh.slices * mesh.data * mesh.model != world * local:
        raise ValueError(f"mesh {mesh.slices}x{mesh.data}x{mesh.model} != {world} "
                         f"processes x {local} device(s)")
    if mesh.model > local and local > 1:
        raise NotImplementedError(
            f"a model axis of {mesh.model} over processes of {local} devices each; "
            "the model axis must lie inside one process or span processes of "
            "one device each")
    size = mesh.model if local == 1 else 1
    _groups = _Groups(rank, world, size) if size > 1 else None


def model_info() -> Tuple[int, int]:
    """(this process's index on the model axis, the model axis's size)."""
    return (_groups.model_index, _groups.model_size) if _groups else (0, 1)


def data_info() -> Tuple[int, int]:
    """(this process's index on the batch axis (slice x data), its size):
    the rank and the process count without a model axis."""
    return (_groups.data_index, _groups.data_size) if _groups else process_info()


def model_group():
    """The process group of this process's model axis (None without one)."""
    return _groups.model_group if _groups else None


def data_group():
    """The process group of this process's data axis (None: every process)."""
    return _groups.data_group if _groups else None


def local_batch_slice(global_batch: int, process_id: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """The half-open row range of the global batch this process owns: its
    block by data index (:func:`data_info`; every rank of a model group the
    same rows)."""
    index, count = data_info()
    pid = index if process_id is None else process_id
    pcount = count if process_count is None else process_count
    if global_batch % pcount != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{pcount} processes")
    per = global_batch // pcount
    return slice(pid * per, (pid + 1) * per)


def _device_of_platform(platform: str, device) -> Optional[str]:
    want = {"": None, "cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}
    if platform not in want:
        raise ValueError(f"unknown --dist.platform {platform!r} (cpu, cuda or gpu)")
    want = want[platform]
    if want and device is not None and torch.device(device).type != want:
        raise ValueError(f"--dist.platform {platform} disagrees with device {device}")
    return device if device is not None else want


def backend_for(collectives: str, device: torch.device) -> str:
    """The process group's backend: `collectives` when given, else NCCL on
    CUDA and gloo on the CPU."""
    if collectives not in ("", "gloo", "nccl"):
        raise ValueError(f"unknown --dist.collectives {collectives!r} (gloo or nccl)")
    if collectives == "nccl" and device.type != "cuda":
        raise ValueError("--dist.collectives nccl needs CUDA devices; the CPU runs gloo")
    return collectives or ("nccl" if device.type == "cuda" else "gloo")


def check_local_devices(dist_cfg, device=None) -> None:
    """Raise for a --dist.local-devices that cannot be: below 0, or above 1
    on CUDA (the count is the CPU's virtual devices, as h36x's
    `jax_num_cpu_devices`; on CUDA every visible card is a local device, or
    one card per process)."""
    if dist_cfg.local_devices < 0:
        raise ValueError(f"--dist.local-devices {dist_cfg.local_devices} < 0")
    if dist_cfg.local_devices > 1 and device is not None and \
            torch.device(device).type != "cpu":
        raise ValueError(
            f"--dist.local-devices {dist_cfg.local_devices} is the CPU's virtual "
            f"device count (--dist.platform cpu); on {torch.device(device).type} "
            "every visible card is a local device")


def setup_from_config(dist_cfg, device=None) -> List[torch.device]:
    """Apply a :class:`h36x_torch.config.DistConfig`, first thing in a CLI's
    main: the process's devices and, with more than one process, the
    process group. Returns the local device list (also what
    :func:`process_devices` returns afterwards): `device`, else
    `--dist.platform`, else cuda; on the CPU `--dist.local-devices`
    virtual devices (at least one); on CUDA every visible card for one
    process, and card rank % the card count for each of several. The
    default single-process config joins nothing."""
    global _process_devices
    device = resolve_device(_device_of_platform(dist_cfg.platform, device))
    check_local_devices(dist_cfg, device)
    n = dist_cfg.num_processes
    if n > 1:
        rank = dist_cfg.process_id if dist_cfg.process_id >= 0 else int(os.environ["RANK"])
        if not 0 <= rank < n:
            raise ValueError(f"--dist.process-id {rank} outside [0, {n})")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        if device.type == "cuda":
            torch.cuda.set_device(device)
        backend = backend_for(dist_cfg.collectives, device)
        initialize(dist_cfg.coordinator or None, n, rank, backend=backend)
        if backend == "nccl":
            _check_one_rank_per_device(device)
    _process_devices = local_devices(device, dist_cfg.local_devices)
    return list(_process_devices)


def process_devices() -> List[Optional[torch.device]]:
    """This process's devices as :func:`setup_from_config` set them; one
    unnamed device (None) before that."""
    return list(_process_devices) if _process_devices is not None else [None]


def _check_one_rank_per_device(device: torch.device) -> None:
    """Raise unless every rank drives another card: NCCL refuses two ranks
    on one device (it would fail later, obscurely, or hang). Each rank
    posts its card's UUID to the process group's store."""
    rank, world = process_info()
    store = dist.distributed_c10d._get_default_store()
    props = torch.cuda.get_device_properties(device)
    uuid = str(getattr(props, "uuid", "") or f"{socket.gethostname()}:{device.index}")
    store.set(f"h36x_torch/device/{rank}", uuid)
    owners: dict = {}
    for r in range(world):
        owners.setdefault(store.get(f"h36x_torch/device/{r}").decode(), []).append(r)
    shared = [ranks for ranks in owners.values() if len(ranks) > 1]
    if shared:
        raise RuntimeError(
            f"NCCL refuses two ranks on one device: ranks {shared[0]} share card "
            f"{[u for u, r in owners.items() if len(r) > 1][0]}; give each rank "
            "its own card, or pass --dist.collectives gloo")


def shutdown() -> None:
    """Leave the process group, when there is one, and forget the devices."""
    global _groups, _process_devices
    _groups = _process_devices = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def mean_across_processes(tensors: List[torch.Tensor],
                          others: Sequence[List[torch.Tensor]] = ()) -> None:
    """Replace each tensor of `tensors`, in place, by its mean over the
    whole data axis, through one flat float32 buffer: first over this
    process's local data replicas (`tensors`, then each list of `others`:
    the same tensors of the other replicas, on their devices), their
    buffers summed in replica order on `tensors`' device and divided by
    their count; then one all-reduce over the data axis's processes,
    divided by their count. A no-op with one replica and one process."""
    _, world = data_info()
    if (world <= 1 and not others) or not tensors:
        return
    flat = _flat(tensors)
    for ts in others:
        flat = flat + _flat(ts).to(flat.device)
    if others:
        flat.div_(len(others) + 1)
    if world > 1:
        dist.all_reduce(flat, group=data_group())
        flat.div_(world)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def sum_across_processes(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the data axis's processes, in place (a no-op with
    one process there)."""
    if data_info()[1] > 1:
        dist.all_reduce(t, group=data_group())
    return t


def make_multislice_mesh(slices: int, data: int = -1, model: int = 1, devices=None):
    """h36x's (slice, data, model) mesh: :func:`h36x_torch.parallel.mesh.make_mesh`
    with `slices`. The slice axis is a TPU pod's DCN hop in h36x; here it
    is one more split of the batch rows (processes, or their local
    devices), with the same rows, gradients and params as a data axis of
    slices x data."""
    from h36x_torch.parallel.mesh import make_mesh

    return make_mesh(data, model, devices, slices=slices)
