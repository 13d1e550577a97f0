"""Camera models (counterpart of h36x/geometry/camera.py): pinhole
projection through intrinsics K (torch), and the host-side numpy helpers
that ingest (the extrinsics' Euler rotation) and extraction (intrinsics)
read."""

from __future__ import annotations

import numpy as np
import torch


def rotation_matrix_xyz(angles) -> np.ndarray:
    """Rotation matrix X(x) @ Y(y) @ Z(z) from Euler angles (radians), the
    composition of H36M's camera extrinsics in metadata.xml."""
    x, y, z = (float(a) for a in np.asarray(angles, dtype=np.float64))
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    X = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (X @ Y) @ Z


def intrinsics_matrix(f, c, dtype=np.float32) -> np.ndarray:
    """K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]] from focal lengths and centre."""
    f = np.asarray(f, dtype=dtype).reshape(2)
    c = np.asarray(c, dtype=dtype).reshape(2)
    return np.array(
        [[f[0], 0.0, c[0]], [0.0, f[1], c[1]], [0.0, 0.0, 1.0]], dtype=dtype
    )


def adjust_camera_after_crop_and_resize(f, c, box, out_size: int = 224) -> np.ndarray:
    """K after cropping to `box` (top, left, h, w) and resizing to
    out_size x out_size: the principal point shifts by the crop offset and
    everything scales by out / crop."""
    top, left, hh, ww = (float(v) for v in np.asarray(box).reshape(4))
    sx = out_size / ww
    sy = out_size / hh
    f = np.asarray(f, dtype=np.float32).reshape(2)
    c = np.asarray(c, dtype=np.float32).reshape(2)
    f_new = np.array([f[0] * sx, f[1] * sy], dtype=np.float32)
    c_new = np.array([(c[0] - left) * sx, (c[1] - top) * sy], dtype=np.float32)
    return intrinsics_matrix(f_new, c_new)


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
    # promoted as jnp.einsum does (bfloat16 joints through float32 K)
    dtype = torch.promote_types(K.dtype, P_cam.dtype)
    P_h = torch.einsum("...ij,...j->...i", K.to(dtype), P_cam.to(dtype))
    z = torch.clamp(P_h[..., 2:3], min=eps)
    return P_h[..., 0:2] / z
