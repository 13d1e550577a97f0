"""Fused GroupNorm -> ReLU -> causal temporal conv (+ residual).

Counterpart of h36x/ops/pallas_temporal.py. One half of the PHD residual
block; a full block is two calls (:func:`fused_residual_block`).

- :func:`reference_gn_relu_cconv` is the plain PyTorch version (with the
  `valid_len` masking that the autoregressive rollout needs), in either
  mode of the `precise` switch.
- :func:`fused_gn_relu_cconv` is the wrapper of the CUDA kernel
  `csrc/temporal.cu`: on a CUDA tensor it launches the kernel and counts the
  launch in `fused_gn_relu_cconv.launches`; on a CPU tensor it runs the
  plain version; on any other device it raises. It is differentiable: its
  backward on CUDA tensors is the kernel `csrc/temporal_bwd.cu`
  (:func:`gn_relu_cconv_bwd`, counted in `gn_relu_cconv_bwd.launches`).

The `precise` switch (h36x's has the same name and defaults,
`h36x/ops/pallas_temporal.py::_dot32`): `precise=True` runs in float32
throughout (the training path and parity); `precise=False`, the default
and the serving paths', rounds the conv weights to bfloat16 and the
normalised, ReLU'd activation to a bfloat16 pair (hi + lo, about 16
significant bits, so that the result stays a continuous function of it),
and sums their products in float32 (on the card, the tensor cores: the
kernel's fast route). That is not h36x's fast mode, a single bfloat16 pass
with the activation rounded once: the pair costs twice its products. The
fast route reads a bfloat16 copy of the weights (:func:`bf16_kernel`),
which the serving engines make once; without one it casts them in the
call.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from h36x_torch.ops import _build
from h36x_torch.ops.causal_conv import causal_conv1d


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def bf16_pair(t: torch.Tensor) -> torch.Tensor:
    """t as the fast routes carry an activation: a bfloat16 pair, hi =
    bf16(t) and lo = bf16(t - hi), returned as hi + lo (about 16
    significant bits)."""
    hi = _bf16_round(t)
    return hi + _bf16_round(t - hi)


def bf16_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """The fast route's copy of a conv kernel (K, D, O): bfloat16, contiguous."""
    return kernel.detach().to(torch.bfloat16).contiguous()


def reference_gn_relu_cconv(x, scale, bias, kernel, conv_bias, residual=None,
                            groups: int = 32, eps: float = 1e-5,
                            valid_len=None, precise: bool = True):
    """Plain version: GN -> ReLU -> causal conv [+ residual].

    x (B, T, D), scale/bias (D,), kernel (K, D, O), conv_bias (O,),
    residual optional (B, T, O). GroupNorm statistics are per sample and
    group over (T, D/G), variance two-pass. With `valid_len`, they are taken
    over frames [0, valid_len) only (outputs at t >= valid_len are garbage
    and must not be read). `precise=False` is the fast mode's plain
    version: the activation rounded to a bfloat16 pair (:func:`bf16_pair`)
    and the kernel to bfloat16 before the float32 conv, as the kernel's
    fast route computes them."""
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
    if not precise:
        xn, kernel = bf16_pair(xn), _bf16_round(kernel)
    out = causal_conv1d(xn, kernel, conv_bias)
    if residual is not None:
        out = out + residual
    return out


def _sample_rows(t: torch.Tensor) -> int:
    """Rows between two samples of a (B, T, D) tensor that is dense within
    each sample: T when contiguous, more for `buf[:, :T]`."""
    return t.shape[1] if t.is_contiguous() else t.stride(0) // t.shape[2]


@functools.lru_cache(maxsize=None)
def _fast_workspace(b, t, d, o, k) -> int:
    """Bytes of the fast route's workspace (0: widths it does not take),
    asked of the library once per shape."""
    (lib,) = _build.load("temporal")
    return lib.h36x_gn_relu_cconv_fast_workspace(b, t, d, o, k)


def _launch_forward(x, scale, bias, kernel, conv_bias, residual, groups, eps,
                    precise, kernel_bf16):
    """B1 on CUDA tensors: (out, mean, rstd), mean/rstd (B, G) the GroupNorm
    statistics the backward reuses. x and residual may be the leading rows
    of each sample of a longer buffer (`buf[:, :t]`): the kernel takes the
    rows between their samples. precise=False runs the fast route on
    `kernel_bf16` (cast here when None)."""
    b, t_len, d = x.shape
    k_taps, _, d_out = kernel.shape
    _build.require_cuda_f32("fused_gn_relu_cconv", ("x", "residual"), x=x,
                            scale=scale, bias=bias, kernel=kernel,
                            conv_bias=conv_bias, residual=residual)
    out = torch.empty((b, t_len, d_out), device=x.device, dtype=torch.float32)
    mean, rstd = torch.empty((2, b, groups), device=x.device, dtype=torch.float32)
    (lib,) = _build.load("temporal")
    x_rows = _sample_rows(x)
    res_rows = t_len if residual is None else _sample_rows(residual)
    res_ptr = None if residual is None else residual.data_ptr()
    with _build.on_device(x.device):
        stream = _build.stream_of(x)
        if precise:
            rc = lib.h36x_gn_relu_cconv(
                x.data_ptr(), scale.data_ptr(), bias.data_ptr(), kernel.data_ptr(),
                conv_bias.data_ptr(), res_ptr, mean.data_ptr(), rstd.data_ptr(),
                out.data_ptr(), b, t_len, d, d_out, k_taps, groups, eps, x_rows,
                res_rows, stream)
        else:
            ws_bytes = _fast_workspace(b, t_len, d, d_out, k_taps)
            if ws_bytes == 0:
                raise ValueError(f"fused_gn_relu_cconv(precise=False): the fast route "
                                 f"takes D and O multiples of 64, not D={d}, O={d_out}")
            if kernel_bf16 is None:
                kernel_bf16 = bf16_kernel(kernel)
            if tuple(kernel_bf16.shape) != tuple(kernel.shape):
                raise ValueError(f"kernel_bf16 {tuple(kernel_bf16.shape)} != "
                                 f"kernel {tuple(kernel.shape)}")
            _build.require_cuda_bf16("fused_gn_relu_cconv", x.device,
                                     kernel_bf16=kernel_bf16)
            ws = torch.empty((ws_bytes,), device=x.device, dtype=torch.uint8)
            rc = lib.h36x_gn_relu_cconv_fast(
                x.data_ptr(), scale.data_ptr(), bias.data_ptr(), kernel_bf16.data_ptr(),
                conv_bias.data_ptr(), res_ptr, mean.data_ptr(), rstd.data_ptr(),
                ws.data_ptr(), out.data_ptr(), b, t_len, d, d_out, k_taps, groups, eps,
                x_rows, res_rows, stream)
    _build.check(rc, f"fused_gn_relu_cconv (precise={precise})")
    _build.count_launch(fused_gn_relu_cconv)
    return out, mean, rstd


def gn_relu_cconv_bwd(x, scale, bias, kernel, g, mean, rstd, groups: int = 32):
    """Wrapper of the backward kernel `csrc/temporal_bwd.cu` (CUDA tensors
    only): (dx, dW, dscale, dbias) of GN -> ReLU -> causal conv at output
    gradient g (B, T, O), from the forward's statistics mean/rstd (B, G).
    The conv-bias and residual gradients are not part of it."""
    b, t_len, d = x.shape
    k_taps, _, d_out = kernel.shape
    if tuple(g.shape) != (b, t_len, d_out) or tuple(mean.shape) != (b, groups):
        raise ValueError(f"g {tuple(g.shape)} / mean {tuple(mean.shape)} do not "
                         f"fit x {tuple(x.shape)}, kernel {tuple(kernel.shape)}, "
                         f"groups {groups}")
    _build.require_cuda_f32("gn_relu_cconv_bwd", x=x, scale=scale, bias=bias,
                            kernel=kernel, g=g, mean=mean, rstd=rstd)
    dev = x.device
    da = torch.empty((b, t_len, d), device=dev, dtype=torch.float32)
    part = torch.empty((2, b, d), device=dev, dtype=torch.float32)
    dx = torch.empty_like(da)
    dw = torch.empty((k_taps, d, d_out), device=dev, dtype=torch.float32)
    dscale = torch.empty((d,), device=dev, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    (lib,) = _build.load("temporal_bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.h36x_gn_relu_cconv_bwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), kernel.data_ptr(),
            g.data_ptr(), mean.data_ptr(), rstd.data_ptr(), da.data_ptr(),
            part.data_ptr(), dx.data_ptr(), dw.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), b, t_len, d, d_out, k_taps, groups, stream)
    _build.check(rc, "gn_relu_cconv_bwd")
    gn_relu_cconv_bwd.launches += 1
    return dx, dw, dscale, dbias


gn_relu_cconv_bwd.launches = 0  # kernel launches


class _GnReluCconv(torch.autograd.Function):
    """B1 forward (either route), B2 backward (the custom_vjp of the JAX
    op; float32, the gradient of the float32 function)."""

    @staticmethod
    def forward(ctx, x, scale, bias, kernel, conv_bias, residual, groups, eps,
                precise, kernel_bf16):
        out, mean, rstd = _launch_forward(x, scale, bias, kernel, conv_bias,
                                          residual, groups, eps, precise,
                                          kernel_bf16)
        ctx.save_for_backward(x, scale, bias, kernel, mean, rstd)
        ctx.groups = groups
        ctx.has_residual = residual is not None
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, kernel, mean, rstd = ctx.saved_tensors
        g = g.contiguous()
        dx, dw, dscale, dbias = gn_relu_cconv_bwd(x, scale, bias, kernel, g,
                                                  mean, rstd, ctx.groups)
        # the conv-bias and residual grads stay outside the kernel, as on the TPU
        dres = g if ctx.has_residual else None
        return dx, dscale, dbias, dw, g.sum(dim=(0, 1)), dres, None, None, None, None


def fused_gn_relu_cconv(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, kernel: torch.Tensor,
                        conv_bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None, *,
                        groups: int = 32, eps: float = 1e-5,
                        precise: bool = False,
                        kernel_bf16: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, T, D), scale/bias (D,), kernel (K, D, O), conv_bias (O,),
    residual optional (B, T, O). Returns (B, T, O) float32. On CUDA, x and
    residual may be strided along the batch (the first T rows of each sample
    of a longer buffer); the backward kernel needs them dense.

    `precise` as in the module docstring; `kernel_bf16`, the fast route's
    weight copy (:func:`bf16_kernel`), is read only when precise=False (on
    the CPU as the rounded kernel it equals).

    Differentiable: on CUDA tensors the backward is the kernel of
    :func:`gn_relu_cconv_bwd`; on CPU tensors autograd runs through the
    plain version."""
    b, t_len, d = x.shape
    k_taps, d_in, d_out = kernel.shape
    if d_in != d or d % groups != 0:
        raise ValueError(f"kernel {tuple(kernel.shape)} / groups {groups} do "
                         f"not fit x {tuple(x.shape)}")
    if residual is not None and tuple(residual.shape) != (b, t_len, d_out):
        raise ValueError(f"residual {tuple(residual.shape)} != {(b, t_len, d_out)}")
    if x.device.type == "cpu":
        if not precise and kernel_bf16 is not None:
            kernel = kernel_bf16.to(kernel.dtype)
        return reference_gn_relu_cconv(x, scale, bias, kernel, conv_bias,
                                       residual, groups=groups, eps=eps,
                                       precise=precise)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gn_relu_cconv runs on cuda or cpu, not {x.device}")
    args = (x, scale, bias, kernel, conv_bias, residual, groups, eps, precise,
            kernel_bf16)
    if _build.needs_grad(x, scale, bias, kernel, conv_bias, residual):
        return _GnReluCconv.apply(*args)
    return _launch_forward(*args)[0]  # serving: no autograd node to build


fused_gn_relu_cconv.launches = 0  # kernel launches on CUDA tensors


def fused_residual_block(x, params, *, groups: int = 32, dropout_mask=None,
                         precise: bool = False):
    """Full ResidualBlock as two fused calls, the residual added in the
    second; `dropout_mask`, if given, multiplies the first call's output (the
    training placement). params: {gn1, conv1, gn2, conv2} as in the flax
    tree; a conv may also hold its :func:`bf16_kernel` copy under
    "kernel_bf16", which precise=False reads."""
    h = fused_gn_relu_cconv(
        x, params["gn1"]["scale"], params["gn1"]["bias"],
        params["conv1"]["kernel"], params["conv1"]["bias"], groups=groups,
        precise=precise, kernel_bf16=params["conv1"].get("kernel_bf16"),
    )
    if dropout_mask is not None:
        h = h * dropout_mask
    return fused_gn_relu_cconv(
        h, params["gn2"]["scale"], params["gn2"]["bias"],
        params["conv2"]["kernel"], params["conv2"]["bias"],
        residual=x, groups=groups, precise=precise,
        kernel_bf16=params["conv2"].get("kernel_bf16"),
    )
