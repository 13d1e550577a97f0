"""Parallelism: the mesh of processes and h36x's sharding rules
(:mod:`h36x_torch.parallel.mesh`), data parallelism over torch.distributed
(:mod:`h36x_torch.parallel.distributed`), tensor parallelism over a model
axis of processes (:mod:`h36x_torch.parallel.tensor`), and the
host-to-device feed."""

from h36x_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    param_sharding_rules,
    shard_params,
)
from h36x_torch.parallel.feed import prefetch_to_device  # noqa: F401
