"""The crop reader of the backbones that take extraction's uint8 square
crops themselves (ViT-H, HRNet-W48): the columns of a crop they read and
ImageNet's normalization on the device.

Both read a square crop of `img_size[0]` pixels as its middle
`img_size[1]` columns, as HMR 2.0 feeds its 256 x 256 crops to a 256 x 192
backbone (`x[..., 32:-32]`).
"""

from __future__ import annotations

import torch

from h36x_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD


class CropReader:
    """Mixed into a backbone module that sets `img_size` (h, w)."""

    img_size: tuple

    def columns(self, side: int) -> slice:
        """The columns of a `side`-pixel square crop the model reads."""
        h, w = self.img_size
        if side != h:
            raise ValueError(f"{side}-pixel crops given; this {type(self).__name__} reads "
                             f"{h} x {w} (extract with --resize {h})")
        left = (h - w) // 2
        return slice(left, left + w)

    def normalize(self, x_u8: torch.Tensor) -> torch.Tensor:
        """ImageNet's normalization in float32, its constants copied to the
        device once (a copy from pageable memory would wait for the
        device's queue at every dispatch)."""
        cache = self.__dict__.setdefault("_stats", {})  # device -> (mean, std) there
        stats = cache.get(x_u8.device)
        if stats is None:
            stats = cache[x_u8.device] = (
                torch.from_numpy(IMAGENET_MEAN).to(x_u8.device),
                torch.from_numpy(IMAGENET_STD).to(x_u8.device))
        return (x_u8.float() * (1.0 / 255.0) - stats[0]) / stats[1]
