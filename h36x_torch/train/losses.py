"""Losses and metrics for 3D pose training (counterpart of
h36x/train/losses.py).

- the phase-1 training loss is 3D MSE only;
- MPJPE = mean per-joint L2 distance, in the joints' units;
- bone-length MSE over the 16 H36M edges, tracked, not trained on;
- 2D reprojection MSE through the batch intrinsics K (`lambda_2d`).

The per-row variants (shape (B,)) serve the weighted eval step, so padded
rows can be weighted out of dataset means exactly.
"""

from __future__ import annotations

import functools

import torch

from h36x_torch.geometry.camera import project_with_K
from h36x_torch.geometry.skeleton import edge_index_arrays

_EDGE_SRC, _EDGE_DST = edge_index_arrays()


def mse3d(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all coordinates; the phase-1 training loss."""
    return torch.mean(mse3d_per_row(pred, gt))


def mse2d_reproj(pred3d: torch.Tensor, joints2d: torch.Tensor,
                 K: torch.Tensor) -> torch.Tensor:
    """MSE in pixels² between GT 2D joints (B,T,J,2) and predicted 3D joints
    (B,T,J,3) projected through the intrinsics K (B,3,3)."""
    return torch.mean((project_with_K(pred3d, K) - joints2d) ** 2)


def mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error: mean over (B,T,J) of ||pred-gt||_2."""
    return torch.mean(mpjpe_per_row(pred, gt))


def bone_length_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """MSE between predicted and GT bone lengths; pred, gt (B, T, J, 3)."""
    return torch.mean(bone_length_per_row(pred, gt))


def mse3d_per_row(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2, dim=(1, 2, 3))


def mpjpe_per_row(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.linalg.vector_norm(pred - gt, dim=-1), dim=(1, 2))


@functools.lru_cache(maxsize=None)
def _edges(device: torch.device) -> tuple:
    """The edges' (src, dst) joint indices on `device`, copied there once: a
    copy from host memory inside a CUDA graph capture would fail it."""
    return (torch.as_tensor(_EDGE_SRC, dtype=torch.long, device=device),
            torch.as_tensor(_EDGE_DST, dtype=torch.long, device=device))


def bone_lengths(joints: torch.Tensor) -> torch.Tensor:
    """(..., J, 3) -> (..., E) H36M bone lengths."""
    src, dst = _edges(joints.device)
    return torch.linalg.vector_norm(
        joints.index_select(-2, dst) - joints.index_select(-2, src), dim=-1)


def bone_length_per_row(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((bone_lengths(pred) - bone_lengths(gt)) ** 2, dim=(1, 2))
