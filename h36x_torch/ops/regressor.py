"""Fused iterative-error-feedback joint regressor.

Counterpart of h36x/ops/pallas_regressor.py:

    y = 0
    repeat iters times:  y += relu(relu([phi; y] @ W1 + b1) @ W2 + b2) @ W3 + b3

- :func:`_reference_forward` is the plain PyTorch version, in either mode
  of the `precise` switch.
- :func:`fused_joint_regressor` is the wrapper of the CUDA kernel
  `csrc/regressor.cu` (all rounds in one call): on a CUDA tensor it
  launches the kernel and counts the call in
  `fused_joint_regressor.launches`; on a CPU tensor it runs the plain
  version; on any other device it raises. It is differentiable: its
  backward on CUDA tensors is the kernel `csrc/regressor_bwd.cu`
  (:func:`joint_regressor_bwd`, counted in `joint_regressor_bwd.launches`).

The `precise` switch, as the temporal op's (:mod:`h36x_torch.ops.temporal`,
which says how its fast mode differs from h36x's):
`precise=True` is float32 throughout (one launch); `precise=False`, the
serving paths', rounds the weights to bfloat16 and the activations (phi,
h1, h2, y) to bfloat16 pairs, and sums in float32, y itself carried in
float32 (on the card, a chain of tensor-core GEMMs, counted as one call). It reads the
bfloat16 weight copies of :func:`bf16_weights`, which the serving engines
make once; without them it casts the weights in the call.
"""

from __future__ import annotations

import functools

import torch

from h36x_torch.ops import _build
from h36x_torch.ops.temporal import bf16_pair

P_PAD = 64  # the iterate y is carried P_PAD columns wide (joints_num*3 <= 64)


def bf16_weights(w1, w2, w3):
    """The fast route's weight copies, bfloat16 and contiguous, in the
    layouts its GEMMs read: (w1[:D], w1[D:] padded with zero rows to P_PAD,
    w2, w3 padded with zero columns to P_PAD)."""
    out_dim = w3.shape[1]
    d = w1.shape[0] - out_dim
    bf = torch.bfloat16
    w1y = w1.new_zeros((P_PAD, w1.shape[1]), dtype=bf)
    w1y[:out_dim] = w1[d:]
    w3p = w3.new_zeros((w3.shape[0], P_PAD), dtype=bf)
    w3p[:, :out_dim] = w3
    return (w1[:d].detach().to(bf).contiguous(), w1y, w2.detach().to(bf).contiguous(),
            w3p)


def _reference_forward(phi2d, w1, b1, w2, b2, w3, b3, iters, out_dim,
                       precise: bool = True):
    """Plain version of the regressor loop: phi2d (N, D) -> (N, out_dim).
    precise=False is the fast mode's: the weights rounded to bfloat16, the
    activations phi, h1, h2 and y to bfloat16 pairs (hi + lo, about 16
    significant bits) at each product, y carried in float32, the concat
    split into phi @ W1[:D] (once) + y @ W1[D:], as the kernel's fast route
    computes it."""
    y = torch.zeros((phi2d.shape[0], out_dim), dtype=phi2d.dtype,
                    device=phi2d.device)
    if precise:
        for _ in range(iters):
            inp = torch.cat([phi2d, y], dim=-1)
            h = torch.relu(inp @ w1 + b1)
            h = torch.relu(h @ w2 + b2)
            y = y + h @ w3 + b3
        return y

    def r(t):
        return t.to(torch.bfloat16).to(t.dtype)

    r2 = bf16_pair

    d = phi2d.shape[1]
    w1y, w2r, w3r = r(w1[d:]), r(w2), r(w3)
    pw1 = r2(phi2d) @ r(w1[:d])
    for _ in range(iters):
        h = torch.relu(pw1 + r2(y) @ w1y + b1)
        h = torch.relu(r2(h) @ w2r + b2)
        y = y + r2(h) @ w3r + b3
    return y


@functools.lru_cache(maxsize=None)
def _fast_workspace(n, d, hidden, out_dim) -> int:
    """Bytes of the fast route's workspace (0: widths it does not take),
    asked of the library once per shape."""
    (lib,) = _build.load("regressor")
    return lib.h36x_joint_regressor_fast_workspace(n, d, hidden, out_dim)


def _launch_forward(phi2d, w1, b1, w2, b2, w3, b3, iters, out_dim, precise,
                    weights_bf16):
    n, d = phi2d.shape
    hidden = w2.shape[0]
    _build.require_cuda_f32("fused_joint_regressor", phi2d=phi2d, w1=w1, b1=b1,
                            w2=w2, b2=b2, w3=w3, b3=b3)
    out = torch.empty((n, P_PAD), device=phi2d.device, dtype=torch.float32)
    (lib,) = _build.load("regressor")
    with _build.on_device(phi2d.device):
        stream = _build.stream_of(phi2d)
        if precise:
            rc = lib.h36x_joint_regressor(
                phi2d.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
                n, d, hidden, out_dim, iters, stream)
        else:
            ws_bytes = _fast_workspace(n, d, hidden, out_dim)
            if ws_bytes == 0 or iters < 1:
                raise ValueError(
                    f"fused_joint_regressor(precise=False): the fast route takes D "
                    f"and H multiples of 64 and iters >= 1, not D={d}, H={hidden}, "
                    f"iters={iters}")
            if weights_bf16 is None:
                weights_bf16 = bf16_weights(w1, w2, w3)
            w1p, w1y, w2b, w3p = weights_bf16
            want = ((d, hidden), (P_PAD, hidden), (hidden, hidden), (hidden, P_PAD))
            if tuple(tuple(w.shape) for w in weights_bf16) != want:
                raise ValueError(f"weights_bf16 {[tuple(w.shape) for w in weights_bf16]}"
                                 f" != {list(want)}")
            _build.require_cuda_bf16("fused_joint_regressor", phi2d.device, w1p=w1p,
                                     w1y=w1y, w2=w2b, w3p=w3p)
            ws = torch.empty((ws_bytes,), device=phi2d.device, dtype=torch.uint8)
            rc = lib.h36x_joint_regressor_fast(
                phi2d.data_ptr(), w1p.data_ptr(), w1y.data_ptr(), w2b.data_ptr(),
                w3p.data_ptr(), b1.data_ptr(), b2.data_ptr(), b3.data_ptr(),
                ws.data_ptr(), out.data_ptr(), n, d, hidden, out_dim, iters, stream)
    # a hidden width whose activations outgrow a block's shared memory is
    # refused by the launch's shared-memory attribute, reported in rc
    _build.check(rc, f"fused_joint_regressor (H={hidden}, precise={precise})")
    _build.count_launch(fused_joint_regressor)
    return out[:, :out_dim]


def joint_regressor_bwd(phi2d, w1, b1, w2, b2, w3, b3, g, iters: int = 3):
    """Wrapper of the backward kernel `csrc/regressor_bwd.cu` (CUDA tensors
    only): the grads (dphi, dw1, db1, dw2, db2, dw3, db3) of the regressor
    at output gradient g (N, out_dim)."""
    n, d = phi2d.shape
    hidden = w2.shape[0]
    out_dim = w3.shape[1]
    if tuple(g.shape) != (n, out_dim):
        raise ValueError(f"g {tuple(g.shape)} != {(n, out_dim)}")
    if iters < 1:
        raise ValueError(f"iters={iters}: the regressor runs at least one round")
    _build.require_cuda_f32("joint_regressor_bwd", phi2d=phi2d, w1=w1, b1=b1,
                            w2=w2, b2=b2, w3=w3, b3=b3, g=g)
    (lib,) = _build.load("regressor_bwd")
    dev = phi2d.device
    ws_bytes = lib.h36x_joint_regressor_bwd_workspace(n, hidden, out_dim, iters)
    ws = torch.empty((ws_bytes // 4,), device=dev, dtype=torch.float32)
    grads = [torch.empty_like(t) for t in (phi2d, w1, b1, w2, b2, w3, b3)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.h36x_joint_regressor_bwd(
            phi2d.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), g.data_ptr(),
            ws.data_ptr(), *[t.data_ptr() for t in grads],
            n, d, hidden, out_dim, iters, stream)
    _build.check(rc, f"joint_regressor_bwd (N={n}, H={hidden})")
    joint_regressor_bwd.launches += 1
    return tuple(grads)


joint_regressor_bwd.launches = 0  # kernel launches


class _JointRegressor(torch.autograd.Function):
    """B3 forward (either route), B4 backward (the custom_vjp of the JAX op;
    float32, the gradient of the float32 function)."""

    @staticmethod
    def forward(ctx, phi2d, w1, b1, w2, b2, w3, b3, iters, out_dim, precise,
                weights_bf16):
        ctx.save_for_backward(phi2d, w1, b1, w2, b2, w3, b3)
        ctx.iters = iters
        return _launch_forward(phi2d, w1, b1, w2, b2, w3, b3, iters, out_dim,
                               precise, weights_bf16)

    @staticmethod
    def backward(ctx, g):
        grads = joint_regressor_bwd(*ctx.saved_tensors, g.contiguous(), ctx.iters)
        return (*grads, None, None, None, None)


def fused_joint_regressor(phi2d, w1, b1, w2, b2, w3, b3, iters: int = 3,
                          out_dim: int = 51, *, precise: bool = False,
                          weights_bf16=None) -> torch.Tensor:
    """phi2d (N, D) -> (N, out_dim) float32.

    Weights follow the flax JointRegressor layout: w1 ((D+out_dim), H),
    w2 (H, H), w3 (H, out_dim), biases 1-D. `precise` as in the module
    docstring; `weights_bf16`, the fast route's copies (:func:`bf16_weights`),
    are read only when precise=False (on the CPU as the rounded weights they
    equal). Differentiable: on CUDA tensors the backward is the kernel of
    :func:`joint_regressor_bwd`; on CPU tensors autograd runs through the
    plain version."""
    if out_dim > P_PAD:
        raise ValueError(
            f"fused_joint_regressor pads the iterate to P_PAD={P_PAD} columns "
            f"but out_dim={out_dim} exceeds it (joints_num > {P_PAD // 3}); "
            "use the plain regressor path for larger joint sets")
    n, d = phi2d.shape
    hidden = w2.shape[0]
    if tuple(w1.shape) != (d + out_dim, hidden) or tuple(w3.shape) != (hidden, out_dim):
        raise ValueError(f"regressor weights w1 {tuple(w1.shape)}, w3 "
                         f"{tuple(w3.shape)} do not fit D={d}, out_dim={out_dim}")
    if phi2d.device.type == "cpu":
        if not precise and weights_bf16 is not None:
            w1p, w1y, w2b, w3p = (w.to(w1.dtype) for w in weights_bf16)
            w1, w2, w3 = torch.cat([w1p, w1y[:out_dim]]), w2b, w3p[:, :out_dim]
        return _reference_forward(phi2d, w1, b1, w2, b2, w3, b3, iters, out_dim,
                                  precise)
    if phi2d.device.type != "cuda":
        raise ValueError(f"fused_joint_regressor runs on cuda or cpu, not {phi2d.device}")
    args = (phi2d, w1, b1, w2, b2, w3, b3, iters, out_dim, precise, weights_bf16)
    if _build.needs_grad(phi2d, w1, b1, w2, b2, w3, b3):
        return _JointRegressor.apply(*args)
    return _launch_forward(*args)  # serving: no autograd node to build


fused_joint_regressor.launches = 0  # kernel launches on CUDA tensors
