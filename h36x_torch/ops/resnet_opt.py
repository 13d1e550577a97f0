"""Folded ResNet-50 inference engine, the `opt` extraction engine
(counterpart of h36x/ops/resnet_opt.py). Three weight-side transforms over
the plain module, the same function:

1. BatchNorm folding: every frozen BN becomes a scale on the previous
   conv's kernel plus a bias (:func:`h36x_torch.ops.bottleneck.fold_bn_params`).
2. ImageNet normalize folded into the stem conv: (x/255 - mean)/std is a
   per-channel affine map, so the u8 frames go into the conv after a cast.
3. Space-to-depth stem: the 7x7/2 conv over 3 channels becomes a 4x4/1
   conv over the (H/2, W/2, 12) 2x2 blocks with padding (2, 1):
   k2[a+2, b+2, (dy,dx,c), o] = K[2a+dy+3, 2b+dx+3, c, o] (zero outside the
   7x7 support).

Every stride-1 bottleneck (13 of 16) is one call of
:func:`h36x_torch.ops.bottleneck.fused_bottleneck`, which launches kernel B5
on the card; the stem, max pool and the three stride-2 transition blocks
stay plain PyTorch (cuDNN on the card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from h36x_torch.ops.bottleneck import (
    STAGE_SIZES,
    conv_nhwc,
    fold_resnet50,
    max_pool_nhwc,
    prepare_bottleneck,
    stride1_block,
    transition_block,
)
from h36x_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD


def fold_stem_s2d(stem_kernel, stem_bias, hw: int = 224):
    """Folded stem (7, 7, 3, 64) HWIO + bias -> the s2d kernel (4, 4, 12, 64)
    and a positional bias MAP (hw/2, hw/2, 64), normalization folded in.

    normalize(x) = x*s + t: s folds into the kernel. t cannot fold into a
    scalar bias, since the original conv zero-pads the NORMALIZED image and
    border outputs see t at fewer taps; both forms are affine in x with the
    same linear part, so the exact bias is the original conv of the
    normalized zero image (computed here in float32 with F.conv2d)."""
    k = np.asarray(stem_kernel, np.float32)
    b = np.asarray(stem_bias, np.float32)
    s = 1.0 / (255.0 * IMAGENET_STD)
    t = -IMAGENET_MEAN / IMAGENET_STD
    k_scaled = k * s[None, None, :, None]

    k2 = np.zeros((4, 4, 12, k.shape[3]), np.float32)
    for a in range(-2, 2):
        for bb in range(-2, 2):
            for dy in range(2):
                for dx in range(2):
                    ky, kx = 2 * a + dy + 3, 2 * bb + dx + 3
                    if 0 <= ky < 7 and 0 <= kx < 7:
                        for c in range(3):
                            k2[a + 2, bb + 2, dy * 6 + dx * 3 + c, :] = k_scaled[ky, kx, c, :]

    zero_norm = torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(t, (1, hw, hw, 3)), dtype=np.float32))
    bias_map = conv_nhwc(zero_norm, torch.from_numpy(k), stride=2, padding=3)
    return torch.from_numpy(k2), bias_map[0] + torch.from_numpy(b)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C), 2x2 blocks flattened (dy, dx, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def fold_resnet50_opt(model, hw: int = 224):
    """A ResNet50 (module or state dict) -> (folded blocks, (k2, stem bias
    map)) for :func:`resnet50_opt_forward`."""
    folded, (stem_k, stem_b) = fold_resnet50(model)
    return folded, fold_stem_s2d(stem_k, stem_b, hw)


def prepare_opt(folded: dict, stem2, dtype: torch.dtype, device):
    """The folded engine's weights in `dtype` on `device`, made once per
    weight set (:func:`prepare_bottleneck` for every block)."""
    k2, bias_map = stem2
    return ({name: prepare_bottleneck(f, dtype, device) for name, f in folded.items()},
            (torch.as_tensor(k2).to(device, dtype), torch.as_tensor(bias_map).to(device, dtype)))


def resnet50_opt_forward(frames_u8: torch.Tensor, folded: dict, stem2,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(N, hw, hw, 3) RAW u8 frames -> (N, 2048) float32 pooled features.
    Normalization is inside the stem weights; the only elementwise work on
    the full-resolution tensor is the u8 -> dtype cast feeding the s2d view."""
    dev = frames_u8.device
    k2, bias_map = stem2
    x = space_to_depth(frames_u8.to(dtype))
    x = F.pad(x, (0, 0, 2, 1, 2, 1))  # (C, W, H) from the last axis
    y = conv_nhwc(x, torch.as_tensor(k2).to(dev, dtype))
    y = torch.relu(y + torch.as_tensor(bias_map).to(dev, dtype)[None])
    y = max_pool_nhwc(y)
    for stage, num_blocks in enumerate(STAGE_SIZES, start=1):
        for block in range(num_blocks):
            f = prepare_bottleneck(folded[f"layer{stage}_{block}"], dtype, dev)
            y = transition_block(y, f) if stage > 1 and block == 0 else stride1_block(y, f)
    return y.mean(dim=(1, 2)).float()
