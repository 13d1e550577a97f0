"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

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
