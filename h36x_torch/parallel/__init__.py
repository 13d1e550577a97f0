"""Parallelism: the mesh of processes, the host-to-device feed, and data
parallelism over torch.distributed (:mod:`h36x_torch.parallel.distributed`).
h36x's sharding rules (`batch_sharding`, `param_sharding_rules`,
`shard_params`) place jax.Arrays on a device mesh and have no counterpart
here yet: tensor parallelism comes with a later slice."""

from h36x_torch.parallel.mesh import make_mesh  # noqa: F401
from h36x_torch.parallel.feed import prefetch_to_device  # noqa: F401
