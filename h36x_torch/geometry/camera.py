"""Pinhole projection through intrinsics K (counterpart of
h36x/geometry/camera.py::project_with_K)."""

from __future__ import annotations

import torch


def project_with_K(P_cam: torch.Tensor, K: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Pinhole projection of camera-frame points through intrinsics K.

    P_cam: (..., 3); K: (3,3), (B,3,3), or (B,T,3,3), broadcast against the
    leading dims of P_cam. Returns (..., 2) pixel coordinates."""
    if K.ndim not in (2, 3, 4) or tuple(K.shape[-2:]) != (3, 3):
        raise ValueError(f"unexpected K shape {tuple(K.shape)}; expected "
                         "(3,3), (B,3,3) or (B,T,3,3)")
    # K gains broadcast dims just before its matrix dims until it lines up
    # with P's leading dims
    while K.ndim < P_cam.ndim + 1:
        K = K[..., None, :, :] if K.ndim > 2 else K[None]
    P_h = torch.einsum("...ij,...j->...i", K, P_cam)
    z = torch.clamp(P_h[..., 2:3], min=eps)
    return P_h[..., 0:2] / z
