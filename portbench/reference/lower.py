"""The controls' lower precisions: a tensor rounded to the format the
configuration's own precision would be tempted down to."""

from __future__ import annotations

import torch


def fp8_cast(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude to 448, the format's largest), back in float32."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
