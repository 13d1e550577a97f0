"""PHD temporal pose model as a torch.nn.Module (counterpart of
h36x/models/phd.py).

Parameters keep the flax names and layouts, so `state_dict` keys read like
the flax tree joined by dots — `input_proj.kernel`, `f_movie.block0.gn1.scale`,
`f_3D.fc1.kernel` — Dense kernels are (in, out) and conv kernels (K, D, O).
:func:`params_from_flax` / :func:`params_to_flax` convert between a flax
param tree of numpy arrays and a `state_dict`, bit for bit.

The submodules are parameter containers; the eval-mode forward is the
inference engine :func:`h36x_torch.infer.phd_forward_fused` over
:func:`param_tree` of the module, so the model and the serving path share
one set of ops.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from h36x_torch.infer import (
    phd_forward_fused,
    phd_forward_train_fused,
    phd_forward_train_future,
)
from h36x_torch.utils.runtime import resolve_device


def _uniform_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) — torch's Linear/Conv default scale,
    the init of the flax model."""
    bound = 1.0 / (fan_in ** 0.5)
    with torch.no_grad():
        p.uniform_(-bound, bound, generator=generator)


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.empty(d_out))

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.kernel.shape[0]
        _uniform_(self.kernel, fan_in, generator)
        _uniform_(self.bias, fan_in, generator)


class GroupNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class CausalConv1d(nn.Module):
    def __init__(self, d_in: int, d_out: int, kernel_size: int = 3):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_size, d_in, d_out))
        self.bias = nn.Parameter(torch.empty(d_out))

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.kernel.shape[0] * self.kernel.shape[1]
        _uniform_(self.kernel, fan_in, generator)
        _uniform_(self.bias, fan_in, generator)


class ResidualBlock(nn.Module):
    """GN -> ReLU -> CausalConv -> GN -> ReLU -> CausalConv + skip."""

    def __init__(self, channels: int, kernel_size: int = 3):
        super().__init__()
        self.gn1 = GroupNorm(channels)
        self.conv1 = CausalConv1d(channels, channels, kernel_size)
        self.gn2 = GroupNorm(channels)
        self.conv2 = CausalConv1d(channels, channels, kernel_size)


class CausalTemporalNet(nn.Module):
    """block0 ... block{N-1}; receptive field 1 + 4 * num_blocks."""

    def __init__(self, channels: int, num_blocks: int, kernel_size: int = 3):
        super().__init__()
        for i in range(num_blocks):
            self.add_module(f"block{i}", ResidualBlock(channels, kernel_size))


class JointRegressor(nn.Module):
    """fc1 ((latent + 3J), H), fc2 (H, H), fc3 (H, 3J)."""

    def __init__(self, latent_dim: int, joints_num: int, hidden: int):
        super().__init__()
        out_dim = joints_num * 3
        self.fc1 = Dense(latent_dim + out_dim, hidden)
        self.fc2 = Dense(hidden, hidden)
        self.fc3 = Dense(hidden, out_dim)


class PHDFor3DJoints(nn.Module):
    """Full PHD pose model over precomputed per-frame features.

    forward(feats (B, T, feature_dim)) ->
      phi        (B, T, latent)  movie strips from f_movie
      phi_hat    (B, T, latent)  f_AR output shifted right one step (zeros at t=0)
      joints_phi (B, T, J, 3)    f_3D(phi)
      joints_hat (B, T, J, 3) | None   f_3D(phi_hat) when predict_future

    Parameters are drawn from `generator` (a CPU torch.Generator; seed 0
    when None) and then moved to `device` (cuda unless the caller asks for
    another). The eval forward runs the engine at precise=True (float32):
    the model is the reference the serving engines' fast mode is held to.

    `train=True` runs the training forward of the phase-1 loss path with
    gradients and dropout (masks from `dropout_generator`, on the model's
    device) and returns (phi, joints_phi): f_AR is not run, no phase-1 loss
    reads it. With `use_kernels=False` that is plain autograd through the
    plain ops, the counterpart of `model.apply(train=True)`. With
    `predict_future=True` too it runs phase 2's loss path and returns (phi,
    phi_hat, joints_hat) (:func:`h36x_torch.infer.phd_forward_train_future`):
    plain ops only, so it needs `use_kernels=False` (h36x has no fused
    phase-2 forward).

    `dtype` is the compute dtype (h36x's `PHDFor3DJoints.dtype`: None is
    float32, torch.bfloat16 mixed precision), passed to the engine when
    `use_kernels` is False (:mod:`h36x_torch.infer` says what it casts).
    The parameters stay float32; the kernels compute in float32 whatever
    it is, as h36x's fused step does.

    `tp` is None, or the model's tensor-parallel split
    (:func:`h36x_torch.parallel.tensor.shard_model`): the params are then
    this process's slices and every forward runs
    :func:`h36x_torch.parallel.tensor.forward`, plain ops only.
    """

    def __init__(self, latent_dim: int = 1024, feature_dim: int = 2048,
                 joints_num: int = 17, number_blocks: int = 2,
                 ar_blocks: int = 3, groups: int = 32, kernel_size: int = 3,
                 regressor_iters: int = 3, regressor_hidden: int = 1024,
                 dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.joints_num = joints_num
        self.groups = groups
        self.dropout = dropout
        self.regressor_iters = regressor_iters
        self.tp = None
        self.input_proj = Dense(feature_dim, latent_dim)
        self.f_movie = CausalTemporalNet(latent_dim, number_blocks, kernel_size)
        self.f_AR = CausalTemporalNet(latent_dim, ar_blocks, kernel_size)
        self.f_3D = JointRegressor(latent_dim, joints_num, regressor_hidden)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        self.to(device)

    def forward(self, feats: torch.Tensor, predict_future: bool = False, *,
                use_kernels: bool = True, train: bool = False,
                dropout_generator: Optional[torch.Generator] = None):
        if self.tp is not None:
            if use_kernels and train:
                raise ValueError("a tensor-parallel model trains on the plain ops "
                                 "(h36x refuses --optim.fused with --mesh.model > 1)")
            from h36x_torch.parallel import tensor
            return tensor.forward(self, feats, predict_future, train=train,
                                  dropout_generator=dropout_generator)
        if train and predict_future:
            if use_kernels:
                raise ValueError(
                    "the phase-2 training forward runs the plain ops only "
                    "(h36x has no fused phase-2 forward): pass use_kernels=False")
            return phd_forward_train_future(
                param_tree(self), feats, dropout_generator,
                dropout=self.dropout, joints_num=self.joints_num,
                groups=self.groups, regressor_iters=self.regressor_iters,
                dtype=self.dtype)
        if train:
            return phd_forward_train_fused(
                param_tree(self), feats, dropout_generator,
                dropout=self.dropout, joints_num=self.joints_num,
                groups=self.groups, regressor_iters=self.regressor_iters,
                use_kernels=use_kernels, dtype=self.dtype,
            )
        with torch.inference_mode():
            return phd_forward_fused(
                param_tree(self), feats, predict_future,
                joints_num=self.joints_num, groups=self.groups,
                use_kernels=use_kernels, regressor_iters=self.regressor_iters,
                precise=True, dtype=self.dtype,
            )


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flatten(value, name + "."))
        else:
            flat[name] = value
    return flat


def param_tree(model: nn.Module) -> dict:
    """The module's parameters as a flax-layout nested dict (the tensors
    themselves, no copies) — what the inference engine reads."""
    return _nest(dict(model.named_parameters()))


def params_from_flax(tree: dict) -> dict:
    """flax param tree of numpy arrays -> `state_dict` of CPU tensors,
    bit for bit (load it with `model.load_state_dict`)."""
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in _flatten(tree).items()}


def params_to_flax(state_dict: dict) -> dict:
    """`state_dict` -> flax param tree of numpy arrays, bit for bit."""
    return _nest({k: v.detach().cpu().numpy().copy()
                  for k, v in state_dict.items()})
