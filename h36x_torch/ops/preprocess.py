"""ImageNet normalization (counterpart of h36x/ops/preprocess.py). The
device-side crop-resize front ends of h36x are not carried over: the
extraction path crops and resizes on the host."""

from __future__ import annotations

import numpy as np
import torch

# ImageNet statistics (the reference's torchvision normalization)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def imagenet_normalize(video01: torch.Tensor) -> torch.Tensor:
    """(..., C=3 last) [0, 1] -> ImageNet-normalized, on video01's device."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(video01.device)
    std = torch.from_numpy(IMAGENET_STD).to(video01.device)
    return (video01 - mean) / std
