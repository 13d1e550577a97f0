"""Multi-process data parallelism on torch.distributed (counterpart of
h36x/parallel/distributed.py): one process per device, every process
running the same CLI with its own `--dist.process-id`.

Each process walks the same seeded sampler order and gathers only its
:func:`local_batch_slice` rows of every global batch; the trainer averages
the gradients (and the step's metrics) with one flat all-reduce per update
(:func:`mean_across_processes`) and sums the eval's per-batch sums, so the
updates and the logged means are those of the global batch. Rank 0 alone
prints, writes metrics.jsonl and checkpoints.

Collectives: NCCL on CUDA, gloo on the CPU; `--dist.collectives gloo`
forces gloo on CUDA too (gloo reduces CUDA tensors through the host). NCCL
refuses two ranks on one device, so with NCCL chosen :func:`setup_from_config`
checks that every rank drives its own card and raises otherwise; it never
switches to gloo by itself.
"""

from __future__ import annotations

import os
import socket
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from h36x_torch.utils.runtime import resolve_device

LATER = "is not ported to h36x_torch yet (it comes with a later slice)"


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


def local_batch_slice(global_batch: int, process_id: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """The half-open row range of the global batch this process owns."""
    rank, world = process_info()
    pid = rank if process_id is None else process_id
    pcount = world if process_count is None else process_count
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


def check_local_devices(dist_cfg) -> None:
    """Raise unless --dist.local-devices is 0 or 1: one process drives one
    device."""
    if dist_cfg.local_devices > 1:
        raise NotImplementedError(
            f"--dist.local-devices {dist_cfg.local_devices}: more than one device "
            f"per process (a single-process multi-device mesh) {LATER}; run one "
            "process per device")
    if dist_cfg.local_devices < 0:
        raise ValueError(f"--dist.local-devices {dist_cfg.local_devices} < 0")


def setup_from_config(dist_cfg, device=None) -> torch.device:
    """Apply a :class:`h36x_torch.config.DistConfig`, first thing in a CLI's
    main: the process's device (`device`, else `--dist.platform`, else cuda;
    under several processes on CUDA, card rank % the card count) and, with
    more than one process, the process group. Returns the device. The
    default single-process config only resolves the device."""
    check_local_devices(dist_cfg)
    device = resolve_device(_device_of_platform(dist_cfg.platform, device))
    n = dist_cfg.num_processes
    if n <= 1:
        return device
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
    return device


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
    """Leave the process group, when there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def mean_across_processes(tensors: List[torch.Tensor]) -> None:
    """Replace each tensor, in place, by its mean over the processes, with
    one all-reduce of a flat float32 buffer of them all (a no-op with one
    process). The tensors lie on one device."""
    _, world = process_info()
    if world <= 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat.div_(world)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def sum_across_processes(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the processes, in place (a no-op with one process)."""
    if process_info()[1] > 1:
        dist.all_reduce(t)
    return t
