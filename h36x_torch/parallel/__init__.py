"""Parallelism: the device mesh and h36x's sharding rules
(:mod:`h36x_torch.parallel.mesh`), data parallelism over torch.distributed
(:mod:`h36x_torch.parallel.distributed`) and over a process's local
devices (:mod:`h36x_torch.parallel.local`), tensor parallelism over a
model axis of processes or local devices (:mod:`h36x_torch.parallel.tensor`),
and the host-to-device feed."""

from h36x_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    param_sharding_rules,
    shard_params,
)
from h36x_torch.parallel.feed import prefetch_to_device  # noqa: F401
