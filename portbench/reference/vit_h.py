"""The plain reference of ViTPose-H (Xu et al. 2022, arXiv:2204.12484), the
ViT-H/16 backbone HMR 2.0 runs unchanged (Goel et al. 2023,
arXiv:2305.20091): plain PyTorch, float32, explicit attention. Imported by
nothing of the program.

Equations as ViTPose's released `vit.py` writes them: a 16 x 16 patch
convolution at stride 16 with padding 2 (256 x 192 -> 16 x 12 tokens);
the position embedding's entry 0 added to every token beside the token's
own entry, no class token; 32 pre-LN blocks `x += proj(softmax(q k^T /
sqrt(80)) v)` on LN1 x (16 heads of 80, qkv with bias), then `x +=
fc2(gelu(fc1(LN2 x)))` (5120, the erf GELU), LayerNorm eps 1e-6; then
`last_norm`. Departures from the published description: the feature is the
mean of the 192 output tokens (HMR 2.0's head reads every token; PHD takes
one vector a frame), and the input is the 256 x 256 uint8 crop whose
middle 192 columns are read (HMR 2.0's `x[..., 32:-32]`), ImageNet-
normalized.

Weights are a ViTPose-layout state_dict (`patch_embed.proj`, `pos_embed`,
`blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}`,
`last_norm`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def sizes(config: dict) -> dict:
    """The model's sizes from the configuration file's keys."""
    return dict(img_size=tuple(config["img_size"]), patch=config["patch_size"],
                padding=config["patch_padding"], dim=config["embed_dim"],
                depth=config["depth"], heads=config["num_heads"], mlp=config["mlp_dim"],
                eps=config["layer_norm_eps"])


def tokens(s: dict) -> int:
    h, w = s["img_size"]
    p, pad = s["patch"], s["padding"]
    return ((h + 2 * pad - p) // p + 1) * ((w + 2 * pad - p) // p + 1)


def param_specs(s: dict) -> list:
    """(name, shape, kind) of every tensor; kind "normal", "bias", "gamma"
    or "beta"."""
    d, p, m = s["dim"], s["patch"], s["mlp"]
    specs = [("patch_embed.proj.weight", (d, 3, p, p), "normal"),
             ("patch_embed.proj.bias", (d,), "bias"),
             ("pos_embed", (1, 1 + tokens(s), d), "normal")]
    for i in range(s["depth"]):
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


def make_weights(s: dict, generator: torch.Generator, device,
                 std: float = 0.02) -> Dict[str, torch.Tensor]:
    """float32 weights as timm's ViT init draws them, but for the biases
    and norms: linear, patch and position weights N(0, std) clamped at +-2
    (timm's truncation bounds, 100 std away), biases U(-0.02, 0.02), norm
    gamma U(0.8, 1.2) and beta U(-0.1, 0.1), so that a dropped term shows.
    Two draws: one normal for every weight, one uniform for the rest."""
    specs = param_specs(s)
    normal = [(n, sh) for n, sh, k in specs if k == "normal"]
    other = [(n, sh, k) for n, sh, k in specs if k != "normal"]
    counts = [math.prod(sh) for _, sh in normal]
    z = torch.randn(sum(counts), generator=generator, device=device).mul_(std)
    z.clamp_(-2.0, 2.0)
    out = {n: part.reshape(sh) for (n, sh), part in zip(normal, torch.split(z, counts))}
    ranges = {"bias": (-0.02, 0.02), "gamma": (0.8, 1.2), "beta": (-0.1, 0.1)}
    counts = [math.prod(sh) for _, sh, _ in other]
    u = torch.rand(sum(counts), generator=generator, device=device)
    for (n, sh, k), part in zip(other, torch.split(u, counts)):
        lo, hi = ranges[k]
        out[n] = (lo + (hi - lo) * part).reshape(sh)
    return out


def forward(w: Dict[str, torch.Tensor], crops_u8: torch.Tensor, s: dict,
            cast: Optional[Callable] = None) -> torch.Tensor:
    """(N, S, S, 3) uint8 square crops, S = img_size[0] -> (N, dim)
    float32. `cast`, when given, rounds both operands of every matrix
    product and of the patch convolution (a lower precision's control)."""
    c = cast if cast is not None else (lambda t: t)

    def mm(a, b):
        return c(a) @ c(b)

    h, wd = s["img_size"]
    left = (h - wd) // 2
    x = crops_u8[:, :, left:left + wd].float() / 255.0
    x = (x - torch.tensor(MEAN, device=x.device)) / torch.tensor(STD, device=x.device)
    x = F.conv2d(c(x.permute(0, 3, 1, 2)), c(w["patch_embed.proj.weight"]),
                 w["patch_embed.proj.bias"], stride=s["patch"], padding=s["padding"])
    x = x.flatten(2).transpose(1, 2)
    pos = w["pos_embed"]
    x = x + pos[:, 1:] + pos[:, :1]
    n, t, d = x.shape
    heads, eps = s["heads"], s["eps"]
    hd = d // heads
    for i in range(s["depth"]):
        b = f"blocks.{i}"
        y = F.layer_norm(x, (d,), w[f"{b}.norm1.weight"], w[f"{b}.norm1.bias"], eps)
        qkv = mm(y, w[f"{b}.attn.qkv.weight"].T) + w[f"{b}.attn.qkv.bias"]
        q, k, v = qkv.view(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        a = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        o = mm(a, v).transpose(1, 2).reshape(n, t, d)
        x = x + mm(o, w[f"{b}.attn.proj.weight"].T) + w[f"{b}.attn.proj.bias"]
        y = F.layer_norm(x, (d,), w[f"{b}.norm2.weight"], w[f"{b}.norm2.bias"], eps)
        y = F.gelu(mm(y, w[f"{b}.mlp.fc1.weight"].T) + w[f"{b}.mlp.fc1.bias"])
        x = x + mm(y, w[f"{b}.mlp.fc2.weight"].T) + w[f"{b}.mlp.fc2.bias"]
    x = F.layer_norm(x, (d,), w["last_norm.weight"], w["last_norm.bias"], eps)
    return x.mean(dim=1)
