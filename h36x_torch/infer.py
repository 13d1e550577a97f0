"""Inference engine for the PHD model (the serving path).

Counterpart of h36x/infer.py. Runs the eval-mode computation of
PHDFor3DJoints over a flax-layout param tree of tensors (see
:func:`h36x_torch.models.phd.param_tree`):

  - every ResidualBlock -> two fused GN+ReLU+causal-conv calls
    (:mod:`h36x_torch.ops.temporal`);
  - the iterative joint regressor -> one fused call
    (:mod:`h36x_torch.ops.regressor`).

With `use_kernels=True` (the default) those calls go to the CUDA kernels
for CUDA tensors and to the plain versions for CPU tensors;
`use_kernels=False` runs the plain versions on any device. The model's own
forward (:class:`h36x_torch.models.phd.PHDFor3DJoints`) is this engine.
"""

from __future__ import annotations

from typing import Optional

import torch

from h36x_torch.ops.regressor import _reference_forward, fused_joint_regressor
from h36x_torch.ops.temporal import fused_residual_block, reference_gn_relu_cconv


def sorted_blocks(net_params: dict):
    """Residual-block names in execution order (block0, block1, ... —
    numeric suffix sort)."""
    return sorted(net_params.keys(), key=lambda n: int(n.removeprefix("block")))


def _plain_block(x, p, groups, valid_len=None):
    h = reference_gn_relu_cconv(
        x, p["gn1"]["scale"], p["gn1"]["bias"],
        p["conv1"]["kernel"], p["conv1"]["bias"], groups=groups,
        valid_len=valid_len,
    )
    return reference_gn_relu_cconv(
        h, p["gn2"]["scale"], p["gn2"]["bias"],
        p["conv2"]["kernel"], p["conv2"]["bias"],
        residual=x, groups=groups, valid_len=valid_len,
    )


def _temporal_net(x, net_params, groups, use_kernels):
    for name in sorted_blocks(net_params):
        p = net_params[name]
        if use_kernels:
            x = fused_residual_block(x, p, groups=groups)
        else:
            x = _plain_block(x, p, groups)
    return x


def _temporal_net_masked(x, net_params, groups, valid_len):
    """Plain temporal net with GroupNorm statistics masked to
    [0, valid_len) — what fixed-shape autoregressive rollout needs (GN is
    the block's one non-causal op). Outputs at t >= valid_len are invalid."""
    for name in sorted_blocks(net_params):
        x = _plain_block(x, net_params[name], groups, valid_len=valid_len)
    return x


def _regressor(phi, reg_params, joints_num, use_kernels, iters=3):
    b, t, d = phi.shape
    out_dim = joints_num * 3
    args = (phi.reshape(b * t, d),
            reg_params["fc1"]["kernel"], reg_params["fc1"]["bias"],
            reg_params["fc2"]["kernel"], reg_params["fc2"]["bias"],
            reg_params["fc3"]["kernel"], reg_params["fc3"]["bias"])
    if use_kernels:
        y = fused_joint_regressor(*args, iters, out_dim)
    else:
        y = _reference_forward(*args, iters, out_dim)
    return y.reshape(b, t, joints_num, 3)


def _movie(params, feats, groups, use_kernels):
    """input_proj -> f_movie: the movie strips phi (B, T, latent)."""
    x = feats @ params["input_proj"]["kernel"] + params["input_proj"]["bias"]
    return _temporal_net(x, params["f_movie"], groups, use_kernels)


def phd_forward_fused(
    params: dict,
    feats: torch.Tensor,
    predict_future: bool = False,
    *,
    joints_num: int = 17,
    groups: int = 32,
    use_kernels: bool = True,
    regressor_iters: int = 3,
):
    """Eval-mode PHD forward over precomputed features (B, T, F).

    params: the flax-layout param tree of tensors. Returns
    (phi, phi_hat, joints_phi, joints_hat|None) like the model; phi_hat is
    the f_AR output shifted right one step, zeros at t=0.
    regressor_iters must match the checkpoint's training config — a
    mismatch runs silently with systematically wrong joints.
    """
    phi = _movie(params, feats, groups, use_kernels)
    ar_out = _temporal_net(phi, params["f_AR"], groups, use_kernels)
    phi_hat = torch.cat([torch.zeros_like(ar_out[:, :1]), ar_out[:, :-1]], dim=1)
    joints_phi = _regressor(phi, params["f_3D"], joints_num, use_kernels,
                            iters=regressor_iters)
    joints_hat: Optional[torch.Tensor] = None
    if predict_future:
        joints_hat = _regressor(phi_hat, params["f_3D"], joints_num,
                                use_kernels, iters=regressor_iters)
    return phi, phi_hat, joints_phi, joints_hat


def make_fused_forward(joints_num: int = 17, groups: int = 32,
                       use_kernels: bool = True, regressor_iters: int = 3):
    """(params, feats) -> joints (B, T, J, 3): input_proj -> f_movie -> f_3D.

    f_AR is not run: joints do not depend on it (the JAX engine's jit drops
    it as dead code from the same computation)."""

    @torch.inference_mode()
    def forward(params, feats):
        phi = _movie(params, feats, groups, use_kernels)
        return _regressor(phi, params["f_3D"], joints_num, use_kernels,
                          iters=regressor_iters)

    return forward
