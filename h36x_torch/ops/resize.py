"""Bilinear image resize on the device (counterpart of h36x/ops/resize.py),
sampling as torch's `interpolate(mode="bilinear", align_corners=False,
antialias=False)`: the no-crop case of
:func:`h36x_torch.ops.preprocess.crop_resize_matrix`, so whole-image
resizes and the crop front ends share one grid. Two separable 1-D
interpolations as small matmuls: out = Wy @ img @ Wx^T."""

from __future__ import annotations

import functools

import numpy as np
import torch

from h36x_torch.ops.preprocess import crop_resize_matrix


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear matrix, cached per size pair."""
    return crop_resize_matrix(0, in_size, in_size, out_size)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear-resize the trailing two axes of (..., H, W) (channels, if
    any, lead: (T, C, H, W)); float32 on img's device."""
    in_h, in_w = img.shape[-2], img.shape[-1]
    wy = torch.from_numpy(_interp_matrix(in_h, out_h)).to(img.device)
    wx = torch.from_numpy(_interp_matrix(in_w, out_w)).to(img.device)
    x = img.float()
    x = torch.einsum("oh,...hw->...ow", wy, x)
    return torch.einsum("pw,...ow->...op", wx, x)
