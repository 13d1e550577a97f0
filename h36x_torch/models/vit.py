"""ViTPose-H, the ViT-H/16 pose backbone (Xu et al. 2022, arXiv:2204.12484)
that HMR 2.0 (Goel et al. 2023, arXiv:2305.20091) runs unchanged, as a
per-frame feature backbone for extraction.

The equations are those of ViTPose's released `vit.py`:

- patch embedding: a P x P convolution at stride P with padding 2, which
  maps a 256 x 192 input to 16 x 12 = 192 tokens;
- position embedding: learned, 1 + tokens entries; entry 0 is added to
  every token and there is no class token;
- each of the pre-LN blocks: `x += proj(attn(LN1 x))`, then
  `x += fc2(gelu(fc1(LN2 x)))`, GELU in its erf form;
- then `last_norm`.

The feature is the mean of the output tokens (HMR 2.0's own head reads
all of them; PHD takes one vector a frame). Extraction hands the model
square crops of `img_size[0]` pixels and the model reads their middle
`img_size[1]` columns, as HMR 2.0 feeds its 256 x 256 crops
(`x[..., 32:-32]`).

Precision: weights and activations in the module's dtype (bfloat16 for
extraction); LayerNorm's statistics and the softmax are computed in
float32 by the kernels (ATen's layer norm and scaled-dot-product
attention accumulate bf16 in float32); the features are returned as
float32. The GEMMs are cuBLAS's and the attention
`torch.nn.functional.scaled_dot_product_attention`.

Parameter names are ViTPose's (`patch_embed.proj`, `pos_embed`,
`blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}`,
`last_norm`), so a ViTPose or HMR 2.0 checkpoint's backbone loads as it is
(:func:`load_vitpose`). The module is built on the `meta` device and
materialized by the load, so that a job does not first draw 632 M random
weights; :func:`random_vit` draws seeded ones where no file is given.

Spans and counters (:mod:`h36x_torch.utils.profiling`), one roofline unit
each: `h36x.vit.embed` (normalization, the column slice, patch conv and
position), `h36x.vit.attention` (LN1, qkv, attention, proj and the
residual add, once a block), `h36x.vit.mlp` (LN2, fc1, GELU, fc2 and the
residual add, once a block), `h36x.vit.head` (last_norm and the token
mean); the counter `h36x.vit.tokens` adds the patch tokens that enter the
blocks.
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from h36x_torch.models.crops import CropReader
from h36x_torch.utils.profiling import count, span

# ViTPose-H / HMR 2.0's backbone at its published widths
VIT_H = dict(img_size=(256, 192), patch=16, padding=2, dim=1280, depth=32, heads=16,
             mlp=5120, eps=1e-6)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim, bias=True)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)
        o = F.scaled_dot_product_attention(q, k, v)  # scale 1 / sqrt(head size)
        return self.proj(o.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp: int, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, mlp)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int, padding: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch, padding=padding)


class ViT(CropReader, nn.Module):
    """ViTPose's backbone: (N, S, S, 3) uint8 square crops, S =
    img_size[0] -> (N, dim) float32 token means (:meth:`forward`), the
    middle img_size[1] columns read."""

    backbone_name = "vit_h"

    def __init__(self, img_size=VIT_H["img_size"], patch=VIT_H["patch"],
                 padding=VIT_H["padding"], dim=VIT_H["dim"], depth=VIT_H["depth"],
                 heads=VIT_H["heads"], mlp=VIT_H["mlp"], eps=VIT_H["eps"],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.img_size = tuple(int(s) for s in img_size)
        self.dim, self.dtype = int(dim), dtype
        h, w = self.img_size
        self.grid = ((h + 2 * padding - patch) // patch + 1,
                     (w + 2 * padding - patch) // patch + 1)
        with torch.device("meta"):  # materialized by load_vitpose or random_vit
            self.patch_embed = PatchEmbed(dim, patch, padding)
            self.pos_embed = nn.Parameter(torch.empty(1, 1 + self.tokens, dim))
            self.blocks = nn.ModuleList(Block(dim, heads, mlp, eps) for _ in range(depth))
            self.last_norm = nn.LayerNorm(dim, eps=eps)
        self.to(dtype)
        self.requires_grad_(False)
        super().train(False)

    @property
    def tokens(self) -> int:
        return self.grid[0] * self.grid[1]

    def train(self, mode: bool = True):
        """Inference only."""
        return super().train(False)

    def forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        with span("h36x.vit.embed"):
            x = frames_u8[:, :, self.columns(int(frames_u8.shape[1]))]
            x = self.normalize(x).to(self.dtype)
            x = self.patch_embed.proj(x.permute(0, 3, 1, 2))
            pos = self.pos_embed
            x = x.flatten(2).transpose(1, 2) + (pos[:, 1:] + pos[:, :1])
        count("h36x.vit.tokens", int(x.shape[0]) * int(x.shape[1]))
        for blk in self.blocks:
            with span("h36x.vit.attention"):
                x = x + blk.attn(blk.norm1(x))
            with span("h36x.vit.mlp"):
                x = x + blk.mlp(blk.norm2(x))
        with span("h36x.vit.head"):
            return self.last_norm(x).mean(dim=1).float()


def load_vitpose(model: ViT, state_dict: dict, device) -> ViT:
    """Materialize `model` (built on `meta`) on `device` in its dtype from a
    ViTPose-layout state_dict: where keys start with `backbone.` (a ViTPose
    or HMR 2.0 checkpoint) those keys without the prefix, the heads left
    out, else all of them. Every key and shape must match."""
    prefix = "backbone."
    sd = state_dict
    if any(k.startswith(prefix) for k in state_dict):
        sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    wrong = sorted(k for k in set(own) & set(sd) if tuple(own[k].shape) != tuple(sd[k].shape))
    if missing or unexpected or wrong:
        raise KeyError(f"not this ViT's state_dict: missing {missing[:5]}, unexpected "
                       f"{unexpected[:5]}, other shapes {wrong[:5]}")
    device = torch.device(device)
    model.load_state_dict({k: sd[k].to(device).to(model.dtype) for k in own}, assign=True)
    return model.requires_grad_(False)


def load_vitpose_file(model: ViT, path, device) -> ViT:
    """:func:`load_vitpose` from a torch.save'd file (a bare state_dict or
    {"state_dict": ...}), mapped from disk rather than read whole."""
    raw = torch.load(Path(path), map_location="cpu", weights_only=True, mmap=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return load_vitpose(model, raw, device)


def random_vit(device, seed: int = 0, dtype: torch.dtype = torch.bfloat16, **sizes) -> ViT:
    """A ViT with timm's ViT init drawn on `device` from `seed`: linear,
    patch and position weights truncated normal (std 0.02), biases 0,
    LayerNorms 1 and 0."""
    model = ViT(dtype=dtype, **sizes)
    model.to_empty(device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif "norm" in name:
                p.fill_(1.0)
            else:
                p.copy_(nn.init.trunc_normal_(torch.empty(p.shape, device=device), std=0.02,
                                              generator=g))
    return model


def backbone(weights: str, device) -> ViT:
    """Extraction's ViT-H at :data:`VIT_H`'s widths on `device`: from a
    ViTPose-layout file, or seeded where `weights` is ""."""
    if not weights:
        return random_vit(device, **VIT_H)
    return load_vitpose_file(ViT(**VIT_H), weights, device)
