"""Causal temporal convolution (counterpart of h36x/ops/causal_conv.py).

The time axis is padded on the left with `kernel_size - 1` copies of the
first frame (edge padding, not zeros), then an unpadded 1-D convolution runs
over time, so output t sees only inputs <= t. The op is one
(B*T, K*D) x (K*D, O) matrix product over the K stacked time-shifted views.
"""

from __future__ import annotations

from typing import Optional

import torch


def causal_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, T, D), kernel (K, D, O) — tap k multiplies x[t - K + 1 + k] —
    bias optional (O,). Returns (B, T, O)."""
    k, d, o = kernel.shape
    b, t, _ = x.shape
    if k > 1:
        x_pad = torch.cat([x[:, :1].expand(b, k - 1, d), x], dim=1)
    else:
        x_pad = x
    taps = torch.stack([x_pad[:, i:i + t] for i in range(k)], dim=2)
    y = (taps.reshape(b * t, k * d) @ kernel.reshape(k * d, o)).reshape(b, t, o)
    if bias is not None:
        y = y + bias
    return y
