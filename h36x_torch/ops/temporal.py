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
  (:func:`gn_relu_cconv_bwd`, counted in `gn_relu_cconv_bwd.launches` and
  per route in `gn_relu_cconv_bwd.launches_by_route`).

The backward kernel has two routes, a pure function of the widths
(:func:`temporal_bwd_route`): "hopper" (D and O multiples of 64) runs its
products on the tensor cores at float32 accuracy, each float32 operand
split into three bf16 parts and six passes (:func:`dot_split`; h36x's
`h36x/ops/pallas_temporal.py::_dot32(precise=True)` takes two parts and
three passes, :func:`dot3`, which misses the gradient tolerance at the
training shape); "general" (the first design, FP32) takes the other widths.
:func:`reference_gn_relu_cconv_bwd_split` is the hopper route's plain
version (explicit formulas, every product a :func:`dot_split`), and
:func:`bwd_on_route` launches one named route, uncounted, to compare or
time the two on the same inputs. The backward runs the same way whatever
the forward's `precise` was (h36x's single-pass backward at
precise=False has no caller in either package).

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


def bf16_parts(t: torch.Tensor, parts: int = 3) -> list:
    """t (float32) split into `parts` bfloat16 parts, as the backward
    kernels' hopper routes store a float32 operand: p0 = bf16(t), p1 =
    bf16(t - p0), p2 = bf16(t - p0 - p1) (each difference exact in
    float32), returned as float32. Two parts keep about 16 significant
    bits, three float32's 24."""
    out, rest = [], t
    for _ in range(parts):
        part = _bf16_round(rest)
        out.append(part)
        rest = rest - part
    return out


def dot_split(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """a @ b with both operands split into `parts` bfloat16 parts
    (:func:`bf16_parts`) and every product a_i @ b_j with i + j < parts
    taken in float32, largest first: the passes of the hopper routes'
    K segments (hopper.cuh's split_passes)."""
    pa, pb = bf16_parts(a, parts), bf16_parts(b, parts)
    out = None
    for s in range(parts):
        for i in range(s + 1):
            term = pa[i] @ pb[s - i]
            out = term if out is None else out + term
    return out


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as h36x's _dot32(precise=True) computes it: both operands split
    into bf16 hi and lo parts (the lo parts rounded to bf16, as the card
    stores them) and three float32 products, a_hi.b_hi + a_hi.b_lo +
    a_lo.b_hi: about 2^-18 of each product's magnitude."""
    return dot_split(a, b, 2)


def bf16_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """The fast route's copy of a conv kernel (K, D, O): bfloat16, contiguous."""
    return kernel.detach().to(torch.bfloat16).contiguous()


def reference_gn_relu_cconv(x, scale, bias, kernel, conv_bias, residual=None,
                            groups: int = 32, eps: float = 1e-5,
                            valid_len=None, precise: bool = True,
                            dtype: Optional[torch.dtype] = None):
    """Plain version: GN -> ReLU -> causal conv [+ residual].

    x (B, T, D), scale/bias (D,), kernel (K, D, O), conv_bias (O,),
    residual optional (B, T, O). GroupNorm statistics are per sample and
    group over (T, D/G), variance two-pass. With `valid_len`, they are taken
    over frames [0, valid_len) only (outputs at t >= valid_len are garbage
    and must not be read). `precise=False` is the fast mode's plain
    version: the activation rounded to a bfloat16 pair (:func:`bf16_pair`)
    and the kernel to bfloat16 before the float32 conv, as the kernel's
    fast route computes them.

    `dtype` is a compute dtype as h36x's flax ResidualBlock takes it
    (`h36x/models/phd.py:85-101`): narrower than 4 bytes, the GroupNorm
    takes float32 statistics and gives a float32 output; the conv casts its
    input, kernel and bias to `dtype`; the residual is cast to the conv's
    dtype. None computes in the operands' own dtypes."""
    if dtype is not None and dtype.itemsize < 4:
        x = x.float()
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
    if dtype is not None:
        xn, kernel, conv_bias = xn.to(dtype), kernel.to(dtype), conv_bias.to(dtype)
    out = causal_conv1d(xn, kernel, conv_bias)
    if residual is not None:
        out = out + residual.to(out.dtype)
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


def gn_stats(x, groups: int = 32, eps: float = 1e-5):
    """GroupNorm statistics (mean, rstd), each (B, G), as the forward kernel
    takes them: per sample and group over (T, D/G), variance two-pass."""
    b, t_len, d = x.shape
    xg = x.reshape(b, t_len, groups, d // groups)
    mean = xg.mean(dim=(1, 3))
    var = ((xg - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
    return mean, 1.0 / torch.sqrt(var + eps)


def reference_gn_relu_cconv_bwd_split(x, scale, bias, kernel, g, groups: int = 32,
                                      eps: float = 1e-5, mean=None, rstd=None,
                                      parts: int = 3):
    """Plain version of the backward kernel's hopper route: (dx, dW, dscale,
    dbias) of GN -> ReLU -> causal conv at output gradient g (B, T, O), the
    two contractions on operands split into `parts` bf16 parts
    (:func:`dot_split`: 3, the kernel's six passes; 2, h36x's three), the
    rest float32. mean/rstd (B, G) are the forward's (:func:`gn_stats` when
    None). Explicit formulas, as `csrc/temporal_bwd.cu` states them:
    dr[j] = sum_k Gk[j] @ W[k]^T with Gk[j] = g[j + s_k] (0 past T) and
    Gk[0] = g[0] + ... + g[min(s_k, T-1)], s_k = K-1-k; da = dr * (a > 0);
    the GroupNorm backward; dW[k] = sum_{b,t} r[b, max(t - s_k, 0)]^T g[b, t]."""
    b, t_len, d = x.shape
    k_taps, _, d_out = kernel.shape
    if mean is None:
        mean, rstd = gn_stats(x, groups, eps)
    gs = d // groups
    mu = mean.repeat_interleave(gs, dim=1)[:, None, :]
    rs = rstd.repeat_interleave(gs, dim=1)[:, None, :]
    xh = (x - mu) * rs
    a = xh * scale + bias
    r = torch.relu(a)
    taps_g, taps_r = [], []
    for k in range(k_taps):
        s = k_taps - 1 - k
        gk = torch.zeros_like(g)
        gk[:, 0] = g[:, :s + 1].sum(dim=1)
        if t_len > s + 1:
            gk[:, 1:t_len - s] = g[:, s + 1:]
        taps_g.append(gk)
        src = (torch.arange(t_len, device=x.device) - s).clamp_min(0)
        taps_r.append(r[:, src])
    rows = b * t_len
    g_taps = torch.cat(taps_g, dim=2).reshape(rows, k_taps * d_out)
    w_t = kernel.permute(0, 2, 1).reshape(k_taps * d_out, d)  # [k*O + o, d] = W[k, d, o]
    dr = dot_split(g_taps, w_t, parts).reshape(b, t_len, d)
    da = dr * (a > 0)
    dscale = (xh * da).sum(dim=(0, 1))
    dbias = da.sum(dim=(0, 1))
    dxh = (da * scale).reshape(b, t_len, groups, gs)
    xhg = xh.reshape(b, t_len, groups, gs)
    m1 = dxh.mean(dim=(1, 3), keepdim=True)
    m2 = (dxh * xhg).mean(dim=(1, 3), keepdim=True)
    dx = rs * (dxh - m1 - xhg * m2).reshape(b, t_len, d)
    r_taps = torch.cat(taps_r, dim=2).reshape(rows, k_taps * d)
    dw = dot_split(r_taps.T, g.reshape(rows, d_out), parts).reshape(k_taps, d, d_out)
    return dx, dw, dscale, dbias


BWD_ROUTES = ("general", "hopper")  # the backward kernel's routes
HOPPER_WIDTH = 64  # the hopper route's K stage and narrowest tile


def temporal_bwd_route(d: int, d_out: int) -> str:
    """The backward kernel's route for input width D and output width O:
    "hopper" when both are multiples of 64, else "general". A function of
    the widths alone (any B and T: rows past B*T read as zeros), decided
    before the launch."""
    if d % HOPPER_WIDTH == 0 and d_out % HOPPER_WIDTH == 0:
        return "hopper"
    return "general"


@functools.lru_cache(maxsize=None)
def _bwd_hopper_workspace(b, t, d, o, k) -> int:
    (lib,) = _build.load("temporal_bwd")
    return lib.h36x_gn_relu_cconv_bwd_hopper_workspace(b, t, d, o, k)


def bwd_on_route(x, scale, bias, kernel, g, mean, rstd, groups: int, route: str):
    """The backward kernel on the named route, CUDA tensors only, uncounted:
    for comparing or timing one route against the other on the same
    inputs. :func:`gn_relu_cconv_bwd` is the entry point, and takes the
    route :func:`temporal_bwd_route` names. A route refused for these
    shapes raises."""
    if route not in BWD_ROUTES:
        raise ValueError(f"gn_relu_cconv_bwd: route {route!r} is not one of {BWD_ROUTES}")
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
    ptrs = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), kernel.data_ptr(),
            g.data_ptr(), mean.data_ptr(), rstd.data_ptr())
    outs = (da.data_ptr(), part.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr())
    dims = (b, t_len, d, d_out, k_taps, groups)
    (lib,) = _build.load("temporal_bwd")
    with _build.on_device(dev):
        stream = _build.stream_of(x)
        if route == "hopper":
            ws_bytes = _bwd_hopper_workspace(b, t_len, d, d_out, k_taps)
            # 0: shapes the route does not take; the entry point refuses them
            ws = torch.empty((max(ws_bytes, 1),), device=dev, dtype=torch.uint8)
            rc = lib.h36x_gn_relu_cconv_bwd_hopper(*ptrs, ws.data_ptr(), *outs, *dims,
                                                   stream)
        else:
            rc = lib.h36x_gn_relu_cconv_bwd(*ptrs, *outs, *dims, stream)
    _build.check(rc, f"gn_relu_cconv_bwd ({route}, D={d}, O={d_out}, B*T={b * t_len})")
    return dx, dw, dscale, dbias


def gn_relu_cconv_bwd(x, scale, bias, kernel, g, mean, rstd, groups: int = 32):
    """Wrapper of the backward kernel `csrc/temporal_bwd.cu` (CUDA tensors
    only): (dx, dW, dscale, dbias) of GN -> ReLU -> causal conv at output
    gradient g (B, T, O), from the forward's statistics mean/rstd (B, G),
    on the route :func:`temporal_bwd_route` names. The conv-bias and
    residual gradients are not part of it."""
    route = temporal_bwd_route(x.shape[2], kernel.shape[2])
    out = bwd_on_route(x, scale, bias, kernel, g, mean, rstd, groups, route)
    if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
        gn_relu_cconv_bwd.launches += 1
        gn_relu_cconv_bwd.launches_by_route[route] += 1
    return out


gn_relu_cconv_bwd.launches = 0  # kernel launches, every route
gn_relu_cconv_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)


class _GnReluCconv(torch.autograd.Function):
    """B1 forward (either route), B2 backward (the custom_vjp of the JAX
    op; the gradient of the float32 function, at h36x's precise
    arithmetic on the hopper route, FP32 on the general one)."""

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
