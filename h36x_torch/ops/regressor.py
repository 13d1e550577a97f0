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
  (:func:`joint_regressor_bwd`, counted in `joint_regressor_bwd.launches`
  and per route in `joint_regressor_bwd.launches_by_route`).

The backward kernel has two routes, a pure function of the widths
(:func:`regressor_bwd_route`): "hopper" (D and H multiples of 64, P <=
P_PAD) runs its products on the tensor cores at float32 accuracy, as the
temporal op's (:func:`~h36x_torch.ops.temporal.dot_split`: three bf16 parts,
six passes); "general" (the first design, FP32) takes the other widths.
:func:`reference_joint_regressor_bwd_split` is the hopper route's plain version
and :func:`bwd_on_route` launches one named route, uncounted. The backward
runs the same way whatever the forward's `precise` was.

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
from h36x_torch.ops.temporal import HOPPER_WIDTH, bf16_pair, dot_split

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


def reference_joint_regressor_bwd_split(phi2d, w1, b1, w2, b2, w3, b3, g,
                                        iters: int = 3, parts: int = 3):
    """Plain version of the backward kernel's hopper route: the grads
    (dphi, dw1, db1, dw2, db2, dw3, db3) of the regressor at output
    gradient g (N, out_dim), every product on operands split into `parts`
    bf16 parts (:func:`dot_split`: 3, the kernel's six passes; 2, h36x's
    three), the rest float32. Explicit formulas, as `csrc/regressor_bwd.cu` states
    them: the forward recomputed (y_0 = 0, pw1 = phi @ W1p, h1_i, h2_i,
    y_{i+1}), then with dY_{iters-1} = g, the last round first:
    dh2_i = (dY_i @ W3^T) * (h2_i > 0), dh1_i = (dh2_i @ W2^T) * (h1_i > 0),
    dY_{i-1} = dY_i + dh1_i @ W1y^T; dpw1 = sum_i dh1_i; dphi = dpw1 @
    W1p^T; the weight gradients over the rows of all rounds stacked; the
    bias gradients the column sums of the sums over rounds."""
    d = phi2d.shape[1]
    w1p, w1y = w1[:d], w1[d:]

    def dot(a, b):
        return dot_split(a, b, parts)

    zeros = torch.zeros_like(g)
    pw1 = dot(phi2d, w1p)
    ys, h1s, h2s = [zeros], [], []
    for it in range(iters):
        h1 = torch.relu(pw1 + b1) if it == 0 else torch.relu(pw1 + dot(ys[it], w1y) + b1)
        h2 = torch.relu(dot(h1, w2) + b2)
        h1s.append(h1)
        h2s.append(h2)
        if it + 1 < iters:
            ys.append(ys[it] + dot(h2, w3) + b3)
    dys, dh1s, dh2s = [None] * iters, [None] * iters, [None] * iters
    dy = dys[iters - 1] = g
    dpw1 = dh2sum = 0
    dysum = g
    for it in reversed(range(iters)):
        dh2s[it] = dot(dy, w3.T) * (h2s[it] > 0)
        dh1s[it] = dot(dh2s[it], w2.T) * (h1s[it] > 0)
        dh2sum = dh2sum + dh2s[it]
        dpw1 = dpw1 + dh1s[it]
        if it > 0:
            dy = dys[it - 1] = dy + dot(dh1s[it], w1y.T)
            dysum = dysum + dy
    cat = torch.cat
    dw1 = cat([dot(phi2d.T, dpw1), dot(cat(ys).T, cat(dh1s))])
    return (dot(dpw1, w1p.T), dw1, dpw1.sum(0), dot(cat(h1s).T, cat(dh2s)),
            dh2sum.sum(0), dot(cat(h2s).T, cat(dys)), dysum.sum(0))


BWD_ROUTES = ("general", "hopper")  # the backward kernel's routes


def regressor_bwd_route(d: int, hidden: int, out_dim: int) -> str:
    """The backward kernel's route for feature width D, hidden width H and
    out_dim P: "hopper" when D and H are multiples of 64 and P <= P_PAD,
    else "general". A function of the widths alone (any N), decided before
    the launch."""
    if d % HOPPER_WIDTH == 0 and hidden % HOPPER_WIDTH == 0 and out_dim <= P_PAD:
        return "hopper"
    return "general"


@functools.lru_cache(maxsize=None)
def _bwd_workspace(route, n, d, hidden, out_dim, iters) -> int:
    (lib,) = _build.load("regressor_bwd")
    if route == "hopper":
        return lib.h36x_joint_regressor_bwd_hopper_workspace(n, d, hidden, out_dim, iters)
    return lib.h36x_joint_regressor_bwd_workspace(n, hidden, out_dim, iters)


def bwd_on_route(phi2d, w1, b1, w2, b2, w3, b3, g, iters: int, route: str):
    """The backward kernel on the named route, CUDA tensors only, uncounted:
    for comparing or timing one route against the other on the same
    inputs. :func:`joint_regressor_bwd` is the entry point, and takes the
    route :func:`regressor_bwd_route` names. A route refused for these
    shapes raises."""
    if route not in BWD_ROUTES:
        raise ValueError(f"joint_regressor_bwd: route {route!r} is not one of {BWD_ROUTES}")
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
    # 0 on the hopper route: shapes it does not take, which its entry point refuses
    ws_bytes = _bwd_workspace(route, n, d, hidden, out_dim, iters)
    ws = torch.empty((max(ws_bytes, 1),), device=dev, dtype=torch.uint8)
    grads = [torch.empty_like(t) for t in (phi2d, w1, b1, w2, b2, w3, b3)]
    entry = (lib.h36x_joint_regressor_bwd_hopper if route == "hopper"
             else lib.h36x_joint_regressor_bwd)
    with _build.on_device(dev):
        rc = entry(phi2d.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                   b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), g.data_ptr(),
                   ws.data_ptr(), *[t.data_ptr() for t in grads],
                   n, d, hidden, out_dim, iters, _build.stream_of(phi2d))
    _build.check(rc, f"joint_regressor_bwd ({route}, N={n}, D={d}, H={hidden})")
    return tuple(grads)


def joint_regressor_bwd(phi2d, w1, b1, w2, b2, w3, b3, g, iters: int = 3):
    """Wrapper of the backward kernel `csrc/regressor_bwd.cu` (CUDA tensors
    only): the grads (dphi, dw1, db1, dw2, db2, dw3, db3) of the regressor
    at output gradient g (N, out_dim), on the route
    :func:`regressor_bwd_route` names."""
    route = regressor_bwd_route(phi2d.shape[1], w2.shape[0], w3.shape[1])
    grads = bwd_on_route(phi2d, w1, b1, w2, b2, w3, b3, g, iters, route)
    if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
        joint_regressor_bwd.launches += 1
        joint_regressor_bwd.launches_by_route[route] += 1
    return grads


joint_regressor_bwd.launches = 0  # kernel launches, every route
joint_regressor_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)


class _JointRegressor(torch.autograd.Function):
    """B3 forward (either route), B4 backward (the custom_vjp of the JAX op;
    the gradient of the float32 function, at h36x's precise arithmetic on
    the hopper route, FP32 on the general one)."""

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
