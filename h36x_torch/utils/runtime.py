"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import List, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    another. Asking for CUDA where there is none raises — an entry point
    never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; h36x_torch runs on the GPU "
            "by default — pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU")
    return dev


def local_devices(device: Optional[Union[str, torch.device]] = None,
                  count: int = 0) -> List[torch.device]:
    """This process's devices, the counterpart of `jax.local_devices()`:

    - CUDA (the default): every visible card, `cuda:0` ... `cuda:n-1`, or
      the first `count` of them when `count` > 0 (more than exist raises);
      a device with an index (`cuda:1`) is that card alone;
    - the CPU: `max(1, count)` virtual devices, each `cpu` (h36x's
      `jax_num_cpu_devices`, `--dist.local-devices N`).

    A virtual device list names one device several times; the mesh treats
    each entry as a device of its own."""
    dev = resolve_device(device)
    if count < 0:
        raise ValueError(f"local device count {count} < 0")
    if dev.type == "cpu":
        return [dev] * max(1, count)
    if dev.type != "cuda":
        raise ValueError(f"no local device list for {dev.type!r} devices")
    if dev.index is not None:
        if count > 1:
            raise ValueError(f"{count} local devices asked of the one card {dev}")
        return [dev]
    n = torch.cuda.device_count()
    if count > n:
        raise ValueError(f"{count} CUDA devices asked for; this host has {n}")
    return [torch.device("cuda", i) for i in range(count or n)]
