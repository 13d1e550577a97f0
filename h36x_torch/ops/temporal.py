"""Fused GroupNorm -> ReLU -> causal temporal conv (+ residual).

Counterpart of h36x/ops/pallas_temporal.py. One half of the PHD residual
block; a full block is two calls (:func:`fused_residual_block`).

- :func:`reference_gn_relu_cconv` is the plain PyTorch version (with the
  `valid_len` masking that the autoregressive rollout needs).
- :func:`fused_gn_relu_cconv` is the wrapper of the CUDA kernel
  `csrc/temporal.cu`: on a CUDA tensor it launches the kernel and counts the
  launch in `fused_gn_relu_cconv.launches`; on a CPU tensor it runs the
  plain version; on any other device it raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from h36x_torch.ops import _build
from h36x_torch.ops.causal_conv import causal_conv1d


def reference_gn_relu_cconv(x, scale, bias, kernel, conv_bias, residual=None,
                            groups: int = 32, eps: float = 1e-5,
                            valid_len=None):
    """Plain version: GN -> ReLU -> causal conv [+ residual].

    x (B, T, D), scale/bias (D,), kernel (K, D, O), conv_bias (O,),
    residual optional (B, T, O). GroupNorm statistics are per sample and
    group over (T, D/G), variance two-pass. With `valid_len`, they are taken
    over frames [0, valid_len) only (outputs at t >= valid_len are garbage
    and must not be read)."""
    b, t_len, d = x.shape
    xg = x.reshape(b, t_len, groups, d // groups)
    if valid_len is None:
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    else:
        mask = (torch.arange(t_len, device=x.device) < valid_len).to(x.dtype)
        mask = mask[None, :, None, None]
        cnt = valid_len * (d // groups)
        mean = (xg * mask).sum(dim=(1, 3), keepdim=True) / cnt
        var = (((xg - mean) ** 2) * mask).sum(dim=(1, 3), keepdim=True) / cnt
    xn = ((xg - mean) / torch.sqrt(var + eps)).reshape(b, t_len, d)
    xn = torch.relu(xn * scale + bias)
    out = causal_conv1d(xn, kernel, conv_bias)
    if residual is not None:
        out = out + residual
    return out


def fused_gn_relu_cconv(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, kernel: torch.Tensor,
                        conv_bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None, *,
                        groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """x (B, T, D), scale/bias (D,), kernel (K, D, O), conv_bias (O,),
    residual optional (B, T, O). Returns (B, T, O) float32."""
    b, t_len, d = x.shape
    k_taps, d_in, d_out = kernel.shape
    if d_in != d or d % groups != 0:
        raise ValueError(f"kernel {tuple(kernel.shape)} / groups {groups} do "
                         f"not fit x {tuple(x.shape)}")
    if residual is not None and tuple(residual.shape) != (b, t_len, d_out):
        raise ValueError(f"residual {tuple(residual.shape)} != {(b, t_len, d_out)}")
    if x.device.type == "cpu":
        return reference_gn_relu_cconv(x, scale, bias, kernel, conv_bias,
                                       residual, groups=groups, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gn_relu_cconv runs on cuda or cpu, not {x.device}")
    _build.require_cuda_f32("fused_gn_relu_cconv", x=x, scale=scale, bias=bias,
                            kernel=kernel, conv_bias=conv_bias,
                            residual=residual)
    out = torch.empty((b, t_len, d_out), device=x.device, dtype=torch.float32)
    mean = torch.empty((b, groups), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    (lib,) = _build.load("temporal")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.h36x_gn_relu_cconv(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), kernel.data_ptr(),
            conv_bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), out.data_ptr(),
            b, t_len, d, d_out, k_taps, groups, eps, stream)
    _build.check(rc, "fused_gn_relu_cconv")
    fused_gn_relu_cconv.launches += 1
    return out


fused_gn_relu_cconv.launches = 0  # kernel launches on CUDA tensors


def fused_residual_block(x, params, *, groups: int = 32):
    """Full ResidualBlock (eval mode) as two fused calls, the residual added
    in the second. params: {gn1, conv1, gn2, conv2} as in the flax tree."""
    h = fused_gn_relu_cconv(
        x, params["gn1"]["scale"], params["gn1"]["bias"],
        params["conv1"]["kernel"], params["conv1"]["bias"], groups=groups,
    )
    return fused_gn_relu_cconv(
        h, params["gn2"]["scale"], params["gn2"]["bias"],
        params["conv2"]["kernel"], params["conv2"]["bias"],
        residual=x, groups=groups,
    )
