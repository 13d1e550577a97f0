"""Crop -> bilinear resize -> [0, 1] front ends on the device and ImageNet
normalization (counterpart of h36x/ops/preprocess.py).

The crop box (top, left, h, w) and the bilinear resize to out_size
(align_corners=False, no antialias: torchvision's resize(antialias=False) of
the cropped frame) are one sampling grid per axis, built on the host by
:func:`crop_resize_grid`, the only place that convention lives. The device
applies it in one of two forms, which agree:

- :func:`fused_crop_resize`, the matrix form: out = Wy @ frame @ Wx^T per
  channel, with the per-clip matrices of :func:`crop_resize_matrices`
  (two GEMMs a frame; the box changes the matrices' values, never shapes);
- :func:`fused_crop_resize_gather`, the gather form: two row gathers and a
  lerp per axis (O(1) work per output where the matrices do O(H)).

Both are plain PyTorch (`torch.einsum`, `index_select`), as h36x's are
jnp ops outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

# ImageNet statistics (the reference's torchvision normalization)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def crop_resize_grid(start: int, size: int, in_size: int, out_size: int):
    """Host: (lo, hi, frac), int32 / int32 / float32 arrays of shape
    (out_size,): output i samples the source at lo[i] and hi[i] with weight
    frac[i] on hi, for the crop [start, start + size) resized to out_size
    (half-pixel centres, clamped into the crop and into the frame)."""
    scale = size / out_size
    src = start + (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    src = np.clip(src, start, start + size - 1)
    src = np.clip(src, 0, in_size - 1)
    lo = np.floor(src).astype(np.int32)
    hi = np.minimum(lo + 1, in_size - 1).astype(np.int32)
    frac = (src - lo).astype(np.float32)
    return lo, hi, frac


def crop_resize_grids(box, img_h: int, img_w: int, out_size: int = 224):
    """Host: box (top, left, h, w) -> (grid_y, grid_x), each (lo, hi, frac)."""
    top, left, hh, ww = (int(v) for v in np.asarray(box).reshape(4))
    return (crop_resize_grid(top, hh, img_h, out_size),
            crop_resize_grid(left, ww, img_w, out_size))


def crop_resize_matrix(start: int, size: int, in_size: int, out_size: int) -> np.ndarray:
    """Host: the (out_size, in_size) float32 matrix of :func:`crop_resize_grid`
    (row i holds 1 - frac at lo and frac at hi)."""
    lo, hi, frac = crop_resize_grid(start, size, in_size, out_size)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo.astype(np.int64)), 1.0 - frac)
    np.add.at(mat, (rows, hi.astype(np.int64)), frac)
    return mat


def crop_resize_matrices(box, img_h: int, img_w: int, out_size: int = 224):
    """Host: box (top, left, h, w) -> (Wy (out, H), Wx (out, W))."""
    top, left, hh, ww = (int(v) for v in np.asarray(box).reshape(4))
    return (crop_resize_matrix(top, hh, img_h, out_size),
            crop_resize_matrix(left, ww, img_w, out_size))


def _on(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x).to(like.device)


def fused_crop_resize(frames: torch.Tensor, wy, wx) -> torch.Tensor:
    """(..., T, H, W, C) uint8 or float frames -> (..., T, out, out, C)
    float32 in [0, 1], on the frames' device. wy (..., out, H) and wx
    (..., out, W) may carry leading dims matching the frames' (per-clip
    matrices: frames (B, T, H, W, C), wy (B, out, H), wx (B, out, W)); the
    frames need their time axis (add a length-1 one for an image)."""
    x = frames.float()
    wy, wx = _on(wy, x).float(), _on(wx, x).float()
    x = torch.einsum("...oh,...thwc->...towc", wy, x)
    x = torch.einsum("...pw,...towc->...topc", wx, x)
    return x * (1.0 / 255.0)


def _lerp_axis(x: torch.Tensor, lo, hi, frac, axis: int) -> torch.Tensor:
    lo, hi = _on(lo, x).long(), _on(hi, x).long()
    a = torch.index_select(x, axis, lo)
    b = torch.index_select(x, axis, hi)
    shape = [1] * x.ndim
    shape[axis] = lo.shape[0]
    f = _on(frac, x).float().reshape(shape)
    return a * (1.0 - f) + b * f


def fused_crop_resize_gather(frames: torch.Tensor, grid_y, grid_x) -> torch.Tensor:
    """(..., H, W, C) frames -> (..., out, out, C) float32 in [0, 1], on the
    frames' device. grid_y / grid_x: (lo, hi, frac) of
    :func:`crop_resize_grids`, one box for every frame given."""
    x = frames.float()
    x = _lerp_axis(x, *grid_y, axis=x.ndim - 3)
    x = _lerp_axis(x, *grid_x, axis=x.ndim - 2)
    return x * (1.0 / 255.0)


def imagenet_normalize(video01: torch.Tensor) -> torch.Tensor:
    """(..., C=3 last) [0, 1] -> ImageNet-normalized, on video01's device."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(video01.device)
    std = torch.from_numpy(IMAGENET_STD).to(video01.device)
    return (video01 - mean) / std
