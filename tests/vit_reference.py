"""The plain reference of ViTPose's backbone (arXiv:2204.12484; HMR 2.0's
ViT-H/16, arXiv:2305.20091) for the CPU tests: plain float32 PyTorch,
explicit attention, nothing of the port and no JAX.

Equations as ViTPose's `vit.py` writes them: a P x P patch convolution at
stride P with padding 2; the position embedding's entry 0 added to every
token beside the token's own entry, no class token; pre-LN blocks
`x += proj(softmax(q k^T / sqrt(head size)) v)` on LN1 x, then
`x += fc2(gelu(fc1(LN2 x)))` with the erf GELU; `last_norm`. The feature is
the mean of the output tokens (an assumption: HMR 2.0's head reads every
token). The input is a square uint8 crop of img_size[0] pixels whose
middle img_size[1] columns are read (HMR 2.0's `x[..., 32:-32]` at 256),
ImageNet-normalized.

Weights are a ViTPose-layout state_dict (`patch_embed.proj`, `pos_embed`,
`blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}`,
`last_norm`). :func:`make_weights` draws them as timm's ViT init does,
with two departures so that a dropped term shows: biases U(-0.02, 0.02)
rather than 0, LayerNorm gamma U(0.8, 1.2) and beta U(-0.1, 0.1) rather
than 1 and 0.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def param_specs(cfg: dict) -> list:
    """(name, shape, kind) of every tensor; kind "normal" (truncated normal),
    "bias", "gamma" or "beta"."""
    d, p, m = cfg["dim"], cfg["patch"], cfg["mlp"]
    h, w = cfg["img_size"]
    pad = cfg["padding"]
    tokens = ((h + 2 * pad - p) // p + 1) * ((w + 2 * pad - p) // p + 1)
    specs = [("patch_embed.proj.weight", (d, 3, p, p), "normal"),
             ("patch_embed.proj.bias", (d,), "bias"),
             ("pos_embed", (1, 1 + tokens, d), "normal")]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        specs += [(f"{b}.norm1.weight", (d,), "gamma"), (f"{b}.norm1.bias", (d,), "beta"),
                  (f"{b}.attn.qkv.weight", (3 * d, d), "normal"),
                  (f"{b}.attn.qkv.bias", (3 * d,), "bias"),
                  (f"{b}.attn.proj.weight", (d, d), "normal"),
                  (f"{b}.attn.proj.bias", (d,), "bias"),
                  (f"{b}.norm2.weight", (d,), "gamma"), (f"{b}.norm2.bias", (d,), "beta"),
                  (f"{b}.mlp.fc1.weight", (m, d), "normal"), (f"{b}.mlp.fc1.bias", (m,), "bias"),
                  (f"{b}.mlp.fc2.weight", (d, m), "normal"), (f"{b}.mlp.fc2.bias", (d,), "bias")]
    specs += [("last_norm.weight", (d,), "gamma"), ("last_norm.bias", (d,), "beta")]
    return specs


def make_weights(cfg: dict, generator: torch.Generator, device="cpu",
                 std: float = 0.02) -> Dict[str, torch.Tensor]:
    """float32 weights: one normal draw (std `std`) for every "normal"
    tensor, clamped at +-2 (timm's truncation bounds, 100 std away at
    0.02), one uniform draw for the rest."""
    specs = param_specs(cfg)
    normal = [(n, s) for n, s, k in specs if k == "normal"]
    other = [(n, s, k) for n, s, k in specs if k != "normal"]
    sizes = [math.prod(s) for _, s in normal]
    z = (torch.randn(sum(sizes), generator=generator, device=device) * std).clamp_(-2.0, 2.0)
    out = {n: part.reshape(s) for (n, s), part in zip(normal, torch.split(z, sizes))}
    ranges = {"bias": (-0.02, 0.02), "gamma": (0.8, 1.2), "beta": (-0.1, 0.1)}
    sizes = [math.prod(s) for _, s, _ in other]
    u = torch.rand(sum(sizes), generator=generator, device=device)
    for (n, s, k), part in zip(other, torch.split(u, sizes)):
        lo, hi = ranges[k]
        out[n] = (lo + (hi - lo) * part).reshape(s)
    return out


def forward(w: Dict[str, torch.Tensor], frames_u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(N, S, S, 3) uint8 crops, S = img_size[0] -> (N, dim) float32."""
    h, wd = cfg["img_size"]
    left = (h - wd) // 2
    x = frames_u8[:, :, left:left + wd].float() / 255.0
    x = (x - torch.tensor(MEAN, device=x.device)) / torch.tensor(STD, device=x.device)
    x = F.conv2d(x.permute(0, 3, 1, 2), w["patch_embed.proj.weight"],
                 w["patch_embed.proj.bias"], stride=cfg["patch"], padding=cfg["padding"])
    x = x.flatten(2).transpose(1, 2)
    pos = w["pos_embed"]
    x = x + pos[:, 1:] + pos[:, :1]
    n, t, d = x.shape
    heads = cfg["heads"]
    hd = d // heads
    eps = cfg["eps"]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        y = F.layer_norm(x, (d,), w[f"{b}.norm1.weight"], w[f"{b}.norm1.bias"], eps)
        qkv = y @ w[f"{b}.attn.qkv.weight"].T + w[f"{b}.attn.qkv.bias"]
        q, k, v = qkv.view(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        o = (a @ v).transpose(1, 2).reshape(n, t, d)
        x = x + o @ w[f"{b}.attn.proj.weight"].T + w[f"{b}.attn.proj.bias"]
        y = F.layer_norm(x, (d,), w[f"{b}.norm2.weight"], w[f"{b}.norm2.bias"], eps)
        y = F.gelu(y @ w[f"{b}.mlp.fc1.weight"].T + w[f"{b}.mlp.fc1.bias"])
        x = x + y @ w[f"{b}.mlp.fc2.weight"].T + w[f"{b}.mlp.fc2.bias"]
    x = F.layer_norm(x, (d,), w["last_norm.weight"], w["last_norm.bias"], eps)
    return x.mean(dim=1)
