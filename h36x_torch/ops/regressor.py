"""Fused iterative-error-feedback joint regressor.

Counterpart of h36x/ops/pallas_regressor.py:

    y = 0
    repeat iters times:  y += relu(relu([phi; y] @ W1 + b1) @ W2 + b2) @ W3 + b3

- :func:`_reference_forward` is the plain PyTorch version.
- :func:`fused_joint_regressor` is the wrapper of the CUDA kernel
  `csrc/regressor.cu` (all rounds in one launch): on a CUDA tensor it
  launches the kernel and counts the launch in
  `fused_joint_regressor.launches`; on a CPU tensor it runs the plain
  version; on any other device it raises. It is differentiable: its
  backward on CUDA tensors is the kernel `csrc/regressor_bwd.cu`
  (:func:`joint_regressor_bwd`, counted in `joint_regressor_bwd.launches`).
"""

from __future__ import annotations

import torch

from h36x_torch.ops import _build

P_PAD = 64  # the iterate y is carried P_PAD columns wide (joints_num*3 <= 64)


def _reference_forward(phi2d, w1, b1, w2, b2, w3, b3, iters, out_dim):
    """Plain version of the regressor loop: phi2d (N, D) -> (N, out_dim)."""
    y = torch.zeros((phi2d.shape[0], out_dim), dtype=phi2d.dtype,
                    device=phi2d.device)
    for _ in range(iters):
        inp = torch.cat([phi2d, y], dim=-1)
        h = torch.relu(inp @ w1 + b1)
        h = torch.relu(h @ w2 + b2)
        y = y + h @ w3 + b3
    return y


def _launch_forward(phi2d, w1, b1, w2, b2, w3, b3, iters, out_dim):
    n, d = phi2d.shape
    hidden = w2.shape[0]
    _build.require_cuda_f32("fused_joint_regressor", phi2d=phi2d, w1=w1, b1=b1,
                            w2=w2, b2=b2, w3=w3, b3=b3)
    out = torch.empty((n, P_PAD), device=phi2d.device, dtype=torch.float32)
    (lib,) = _build.load("regressor")
    with torch.cuda.device(phi2d.device):
        stream = torch.cuda.current_stream(phi2d.device).cuda_stream
        rc = lib.h36x_joint_regressor(
            phi2d.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
            n, d, hidden, out_dim, iters, stream)
    # a hidden width whose activations outgrow a block's shared memory is
    # refused by the launch's shared-memory attribute, reported in rc
    _build.check(rc, f"fused_joint_regressor (H={hidden})")
    fused_joint_regressor.launches += 1
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
    """B3 forward, B4 backward (the custom_vjp of the JAX op)."""

    @staticmethod
    def forward(ctx, phi2d, w1, b1, w2, b2, w3, b3, iters, out_dim):
        ctx.save_for_backward(phi2d, w1, b1, w2, b2, w3, b3)
        ctx.iters = iters
        return _launch_forward(phi2d, w1, b1, w2, b2, w3, b3, iters, out_dim)

    @staticmethod
    def backward(ctx, g):
        grads = joint_regressor_bwd(*ctx.saved_tensors, g.contiguous(), ctx.iters)
        return (*grads, None, None)


def fused_joint_regressor(phi2d, w1, b1, w2, b2, w3, b3, iters: int = 3,
                          out_dim: int = 51) -> torch.Tensor:
    """phi2d (N, D) -> (N, out_dim) float32.

    Weights follow the flax JointRegressor layout: w1 ((D+out_dim), H),
    w2 (H, H), w3 (H, out_dim), biases 1-D. Differentiable: on CUDA tensors
    the backward is the kernel of :func:`joint_regressor_bwd`; on CPU
    tensors autograd runs through the plain version."""
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
        return _reference_forward(phi2d, w1, b1, w2, b2, w3, b3, iters, out_dim)
    if phi2d.device.type != "cuda":
        raise ValueError(f"fused_joint_regressor runs on cuda or cpu, not {phi2d.device}")
    return _JointRegressor.apply(phi2d, w1, b1, w2, b2, w3, b3, iters, out_dim)


fused_joint_regressor.launches = 0  # kernel launches on CUDA tensors
