"""Inference engine for the PHD model (the serving path).

Counterpart of h36x/infer.py. Runs the eval-mode computation of
PHDFor3DJoints over a flax-layout param tree of tensors (see
:func:`h36x_torch.models.phd.param_tree`):

  - every ResidualBlock -> two fused GN+ReLU+causal-conv calls
    (:mod:`h36x_torch.ops.temporal`);
  - the iterative joint regressor -> one fused call
    (:mod:`h36x_torch.ops.regressor`).

:func:`phd_forward_train_fused` is the training forward of the phase-1
loss path through the same ops, differentiable (their backward kernels on
CUDA tensors); :func:`phd_forward_train_future` is phase 2's (plain ops
only: h36x has no fused phase-2 step).

With `use_kernels=True` (the default) those calls go to the CUDA kernels
for CUDA tensors and to the plain versions for CPU tensors;
`use_kernels=False` runs the plain versions on any device. The model's own
forward (:class:`h36x_torch.models.phd.PHDFor3DJoints`) is this engine, at
precise=True.

Precision: the serving entry points default to precise=False, where the
kernels' products take bfloat16 weights and activations carried as
bfloat16 pairs (hi + lo) with float32 sums, about 1e-3 relative to the
float32 model. h36x's precise=False (h36x/infer.py) is a single bfloat16
pass, activations rounded once; the pair is this port's own (twice the
products). precise=True (training, the trainer's eval, the results stage,
the model's own forward) runs in float32. The fast mode reads bfloat16
copies of the weights, which the engines (:func:`make_fused_forward`,
:func:`h36x_torch.serve.make_rollout_fn`, the streaming predictor, the
daemon) make once, where they take the params, by
:func:`serving_params`; a tree without them costs a cast per call.

Compute dtype: `dtype` (h36x's `PHDFor3DJoints.dtype`; None is float32)
applies to the plain path, with the semantics of h36x's flax model
(`h36x/models/phd.py:48-101, 128-158`): every Dense and causal conv casts
its input, kernel and bias to `dtype`; GroupNorm takes float32 statistics
and gives a float32 output when `dtype` is narrower than 4 bytes; the
residual is cast to the conv's dtype; the regressor's iterate starts in
phi's dtype. The params stay as they are (float32). The kernels compute in
float32 whatever `dtype` is, as h36x's fused Pallas step does
(`h36x/train/step.py:79-88` passes no dtype).
"""

from __future__ import annotations

from typing import Optional

import torch

from h36x_torch.ops import regressor as _reg
from h36x_torch.ops import temporal as _tmp
from h36x_torch.ops.regressor import _reference_forward, fused_joint_regressor
from h36x_torch.ops.temporal import fused_residual_block, reference_gn_relu_cconv
from h36x_torch.parallel.distributed import data_info


def sorted_blocks(net_params: dict):
    """Residual-block names in execution order (block0, block1, ... —
    numeric suffix sort)."""
    return sorted(net_params.keys(), key=lambda n: int(n.removeprefix("block")))


def serving_params(params: dict, use_kernels: bool = True,
                   precise: bool = False) -> dict:
    """The param tree an engine serves from. With the kernels on at
    precise=False: a new tree over the same tensors in which every conv of
    f_movie and f_AR also holds its bfloat16 kernel ("kernel_bf16",
    :func:`h36x_torch.ops.temporal.bf16_kernel`) and f_3D the regressor's
    copies ("bf16", :func:`h36x_torch.ops.regressor.bf16_weights`), on the
    params' device. Otherwise params itself."""
    if precise or not use_kernels:
        return params
    out = dict(params)
    for net in ("f_movie", "f_AR"):
        if net in params:
            out[net] = {name: {**p, **{c: {**p[c], "kernel_bf16":
                                           _tmp.bf16_kernel(p[c]["kernel"])}
                                       for c in ("conv1", "conv2")}}
                        for name, p in params[net].items()}
    reg = params["f_3D"]
    out["f_3D"] = {**reg, "bf16": _reg.bf16_weights(
        reg["fc1"]["kernel"], reg["fc2"]["kernel"], reg["fc3"]["kernel"])}
    return out


def _dense(x, p, dtype=None):
    """x @ kernel + bias, with x, kernel and bias cast to the compute
    `dtype` first when one is given (flax's `Dense(dtype=...)`)."""
    w, b = p["kernel"], p["bias"]
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    return x @ w + b


def _plain_block(x, p, groups, valid_len=None, dropout_mask=None,
                 precise: bool = True, dtype=None):
    h = reference_gn_relu_cconv(
        x, p["gn1"]["scale"], p["gn1"]["bias"],
        p["conv1"]["kernel"], p["conv1"]["bias"], groups=groups,
        valid_len=valid_len, precise=precise, dtype=dtype,
    )
    if dropout_mask is not None:
        h = h * dropout_mask
    return reference_gn_relu_cconv(
        h, p["gn2"]["scale"], p["gn2"]["bias"],
        p["conv2"]["kernel"], p["conv2"]["bias"],
        residual=x, groups=groups, valid_len=valid_len, precise=precise,
        dtype=dtype,
    )


def _temporal_net(x, net_params, groups, use_kernels, precise: bool = True,
                  dtype=None):
    for name in sorted_blocks(net_params):
        p = net_params[name]
        if use_kernels:
            x = fused_residual_block(x, p, groups=groups, precise=precise)
        else:
            x = _plain_block(x, p, groups, precise=precise, dtype=dtype)
    return x


def _temporal_net_masked(x, net_params, groups, valid_len, precise: bool = True):
    """Plain temporal net with GroupNorm statistics masked to
    [0, valid_len) — what fixed-shape autoregressive rollout needs (GN is
    the block's one non-causal op). Outputs at t >= valid_len are invalid."""
    for name in sorted_blocks(net_params):
        x = _plain_block(x, net_params[name], groups, valid_len=valid_len,
                         precise=precise)
    return x


def _regressor_args(phi2d, reg_params, dtype=None):
    """(phi2d, w1, b1, w2, b2, w3, b3), cast to the compute `dtype` when one
    is given (phi is in it already under a model dtype, so the iterate,
    which starts in phi's dtype, is too)."""
    args = (phi2d, reg_params["fc1"]["kernel"], reg_params["fc1"]["bias"],
            reg_params["fc2"]["kernel"], reg_params["fc2"]["bias"],
            reg_params["fc3"]["kernel"], reg_params["fc3"]["bias"])
    return args if dtype is None else tuple(a.to(dtype) for a in args)


def _regressor(phi, reg_params, joints_num, use_kernels, iters=3,
               precise: bool = True, dtype=None):
    b, t, d = phi.shape
    out_dim = joints_num * 3
    if use_kernels:
        args = _regressor_args(phi.reshape(b * t, d), reg_params)
        y = fused_joint_regressor(*args, iters, out_dim, precise=precise,
                                  weights_bf16=reg_params.get("bf16"))
    else:
        args = _regressor_args(phi.reshape(b * t, d), reg_params, dtype)
        y = _reference_forward(*args, iters, out_dim, precise)
    return y.reshape(b, t, joints_num, 3)


def _movie(params, feats, groups, use_kernels, precise: bool = True,
           dtype=None):
    """input_proj -> f_movie: the movie strips phi (B, T, latent)."""
    if use_kernels:
        dtype = None
    x = _dense(feats, params["input_proj"], dtype)
    return _temporal_net(x, params["f_movie"], groups, use_kernels, precise,
                         dtype)


def phd_forward_fused(
    params: dict,
    feats: torch.Tensor,
    predict_future: bool = False,
    *,
    joints_num: int = 17,
    groups: int = 32,
    use_kernels: bool = True,
    regressor_iters: int = 3,
    precise: bool = False,
    dtype: Optional[torch.dtype] = None,
):
    """Eval-mode PHD forward over precomputed features (B, T, F).

    params: the flax-layout param tree of tensors (its
    :func:`serving_params`, to read the fast mode's copies). Returns
    (phi, phi_hat, joints_phi, joints_hat|None) like the model; phi_hat is
    the f_AR output shifted right one step, zeros at t=0.
    regressor_iters must match the checkpoint's training config — a
    mismatch runs silently with systematically wrong joints. `precise` and
    `dtype` as in the module docstring.
    """
    phi = _movie(params, feats, groups, use_kernels, precise, dtype)
    ar_out = _temporal_net(phi, params["f_AR"], groups, use_kernels, precise,
                           dtype)
    phi_hat = torch.cat([torch.zeros_like(ar_out[:, :1]), ar_out[:, :-1]], dim=1)
    joints_phi = _regressor(phi, params["f_3D"], joints_num, use_kernels,
                            regressor_iters, precise, dtype)
    joints_hat: Optional[torch.Tensor] = None
    if predict_future:
        joints_hat = _regressor(phi_hat, params["f_3D"], joints_num, use_kernels,
                                regressor_iters, precise, dtype)
    return phi, phi_hat, joints_phi, joints_hat


def make_fused_forward(params: dict, joints_num: int = 17, groups: int = 32,
                       use_kernels: bool = True, regressor_iters: int = 3,
                       precise: bool = False,
                       dtype: Optional[torch.dtype] = None):
    """feats -> joints (B, T, J, 3): input_proj -> f_movie -> f_3D over
    `params` (the flax-layout tree, on the feats' device), whose fast-mode
    copies (:func:`serving_params`) are made here, once. `dtype` as in the
    module docstring.

    f_AR is not run: joints do not depend on it (the JAX engine's jit drops
    it as dead code from the same computation)."""
    params = serving_params(params, use_kernels, precise)

    @torch.inference_mode()
    def forward(feats):
        phi = _movie(params, feats, groups, use_kernels, precise, dtype)
        return _regressor(phi, params["f_3D"], joints_num, use_kernels,
                          regressor_iters, precise, dtype)

    return forward


def dropout_mask(shape, keep: float, generator: torch.Generator, like: torch.Tensor):
    """Inverted-dropout mask (Bernoulli(keep) / keep) in `like`'s dtype,
    drawn in float32 from `generator`, which lives on the tensors' device.
    When the batch is split over the data axis of several processes, each
    holding an equal block of the global batch's rows, it draws the global
    batch's mask (the leading dim batch-major: (B, ...) or (B * T, ...))
    and keeps this process's block (by data index: every rank of a model
    group the same one): every process's generator seeded alike, the masks
    are those of a one-process run of the global batch."""
    rank, processes = data_info()
    rows = shape[0]
    u = torch.rand((rows * processes, *shape[1:]), generator=generator,
                   device=like.device, dtype=torch.float32)[rank * rows:(rank + 1) * rows]
    return (u < keep).to(like.dtype) / keep


def _regressor_train(phi, reg_params, generator, dropout, iters, joints_num,
                     use_kernels, precise: bool = True, dtype=None):
    """Training-mode regressor. At dropout 0 it is the eval regressor (with
    `use_kernels`, the fused one: B3 forward, B4 backward on CUDA tensors);
    with dropout the per-round masks of the flax JointRegressor sit inside
    the loop, which the kernel cannot take, so it runs as plain torch with
    autograd (in the compute `dtype`, when one is given)."""
    if dropout == 0.0:
        return _regressor(phi, reg_params, joints_num, use_kernels, iters=iters,
                          precise=precise, dtype=dtype)
    b, t, d = phi.shape
    out_dim = joints_num * 3
    phi2d, w1, b1, w2, b2, w3, b3 = _regressor_args(phi.reshape(b * t, d),
                                                    reg_params, dtype)
    keep = 1.0 - dropout
    y = torch.zeros((b * t, out_dim), dtype=phi2d.dtype, device=phi.device)
    for _ in range(iters):
        h = torch.relu(torch.cat([phi2d, y], dim=-1) @ w1 + b1)
        h = h * dropout_mask(h.shape, keep, generator, h)
        h = torch.relu(h @ w2 + b2)
        y = y + h @ w3 + b3
    return y.reshape(b, t, joints_num, 3)


def phd_forward_train_fused(
    params: dict,
    feats: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    dropout: float = 0.5,
    joints_num: int = 17,
    groups: int = 32,
    regressor_iters: int = 3,
    use_kernels: bool = True,
    precise: bool = True,
    dtype: Optional[torch.dtype] = None,
):
    """Training forward of the phase-1 loss path (feats -> input_proj ->
    f_movie -> f_3D), with gradients. With `use_kernels` every residual block
    is two fused calls (B1 forward, B2 backward on CUDA tensors) with the
    dropout mask between them, where the flax ResidualBlock puts it; the
    regressor follows :func:`_regressor_train`. `use_kernels=False` is the
    plain autograd path of the same function (the model's train forward).
    Masks are drawn from `generator` (needed when dropout > 0): one per
    block, then one per regressor round, in that order on both paths. f_AR is
    not run: the phase-1 loss never reads it. `precise` defaults to True, as
    h36x trains fused (h36x/infer.py::phd_forward_train_fused). `dtype` is
    the plain path's compute dtype (module docstring): with the kernels the
    step runs in float32 whatever it is, as h36x's fused step does.

    Returns (phi, joints)."""
    if dropout > 0.0 and generator is None:
        raise ValueError("dropout > 0 needs a torch.Generator for its masks")
    if use_kernels:
        dtype = None
    x = _dense(feats, params["input_proj"], dtype)
    x = _temporal_net_train(x, params["f_movie"], generator, dropout, groups,
                            use_kernels, precise, dtype)
    joints = _regressor_train(x, params["f_3D"], generator, dropout,
                              regressor_iters, joints_num, use_kernels, precise,
                              dtype)
    return x, joints


def _temporal_net_train(x, net_params, generator, dropout, groups, use_kernels,
                        precise, dtype=None):
    """Training-mode temporal net: one dropout mask per block, between its
    two convs, drawn in block order."""
    keep = 1.0 - dropout
    for name in sorted_blocks(net_params):
        p = net_params[name]
        mask = None
        if dropout > 0.0:
            shape = x.shape[:2] + (p["conv1"]["kernel"].shape[-1],)
            mask = dropout_mask(shape, keep, generator, x)
        if use_kernels:
            x = fused_residual_block(x, p, groups=groups, dropout_mask=mask,
                                     precise=precise)
        else:
            x = _plain_block(x, p, groups, dropout_mask=mask, precise=precise,
                             dtype=dtype)
    return x


def phd_forward_train_future(
    params: dict,
    feats: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    dropout: float = 0.5,
    joints_num: int = 17,
    groups: int = 32,
    regressor_iters: int = 3,
    dtype: Optional[torch.dtype] = None,
):
    """Training forward of the phase-2 loss path, plain ops with autograd
    (the counterpart of h36x's `model.apply(predict_future=True,
    train=True)`): input_proj -> f_movie -> phi -> f_AR -> shifted one step
    (zeros at t = 0) -> phi_hat -> f_3D(phi_hat). Masks are drawn from
    `generator` in the order f_movie's blocks, f_AR's blocks, the
    regressor's rounds. f_3D(phi) is not run: no phase-2 loss reads it.
    Gradients reach the modules whose params require them (phase 2 freezes
    all but f_AR). `dtype` as in the module docstring. Returns (phi,
    phi_hat, joints_hat)."""
    if dropout > 0.0 and generator is None:
        raise ValueError("dropout > 0 needs a torch.Generator for its masks")
    x = _dense(feats, params["input_proj"], dtype)
    phi = _temporal_net_train(x, params["f_movie"], generator, dropout, groups,
                              False, True, dtype)
    ar_out = _temporal_net_train(phi, params["f_AR"], generator, dropout, groups,
                                 False, True, dtype)
    phi_hat = torch.cat([torch.zeros_like(ar_out[:, :1]), ar_out[:, :-1]], dim=1)
    joints_hat = _regressor_train(phi_hat, params["f_3D"], generator, dropout,
                                  regressor_iters, joints_num, False, True, dtype)
    return phi, phi_hat, joints_hat
