"""The plain reference of ResNet-50 (He et al. 2016, arXiv:1512.03385) in
torchvision's layout (v1.5: the stride on the 3x3 conv), truncated at the
global-average-pooled 2048-D feature: plain PyTorch, float32, NCHW,
batch norm from its running statistics (eps 1e-5). Imported by nothing of
the program.

Weights are a torchvision-named state_dict without the `fc` head.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

STAGES = (3, 4, 6, 3)


def param_specs() -> List[tuple]:
    """(name, shape, kind) of every tensor, kind "conv" (fan_out for its
    scale) or a batch-norm field: "gamma", "gamma3" (a block's last norm),
    "beta", "mean", "var"."""
    specs = [("conv1.weight", (64, 3, 7, 7), "conv")]

    def bn(name, c, last=False):
        return [(f"{name}.weight", (c,), "gamma3" if last else "gamma"),
                (f"{name}.bias", (c,), "beta"), (f"{name}.running_mean", (c,), "mean"),
                (f"{name}.running_var", (c,), "var")]

    specs += bn("bn1", 64)
    c_in = 64
    for s, blocks in enumerate(STAGES):
        m = 64 * 2 ** s
        for b in range(blocks):
            p = f"layer{s + 1}.{b}"
            specs += [(f"{p}.conv1.weight", (m, c_in, 1, 1), "conv")] + bn(f"{p}.bn1", m)
            specs += [(f"{p}.conv2.weight", (m, m, 3, 3), "conv")] + bn(f"{p}.bn2", m)
            specs += [(f"{p}.conv3.weight", (4 * m, m, 1, 1), "conv")] + bn(f"{p}.bn3", 4 * m, True)
            if b == 0:
                specs += ([(f"{p}.downsample.0.weight", (4 * m, c_in, 1, 1), "conv")]
                          + bn(f"{p}.downsample.1", 4 * m))
            c_in = 4 * m
    return specs


def make_weights(generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Convs from N(0, 2 / fan_out) (torchvision's init); batch norm's
    gamma U(0.8, 1.2) (U(0.2, 0.4) on a block's last, as trained networks
    keep the residual branch small), beta and running mean U(-0.1, 0.1),
    running var U(0.8, 1.2). Two draws: one normal for every conv, one
    uniform for every norm."""
    specs = param_specs()
    convs = [(n, s) for n, s, k in specs if k == "conv"]
    norms = [(n, s, k) for n, s, k in specs if k != "conv"]
    sizes = [torch.Size(s).numel() for _, s in convs]
    z = torch.randn(sum(sizes), generator=generator, device=device)
    out = {}
    for (n, s), part in zip(convs, torch.split(z, sizes)):
        out[n] = part.reshape(s) * (2.0 / (s[0] * s[2] * s[3])) ** 0.5
    ranges = {"gamma": (0.8, 1.2), "gamma3": (0.2, 0.4), "beta": (-0.1, 0.1),
              "mean": (-0.1, 0.1), "var": (0.8, 1.2)}
    sizes = [s[0] for _, s, _ in norms]
    u = torch.rand(sum(sizes), generator=generator, device=device)
    for (n, s, k), part in zip(norms, torch.split(u, sizes)):
        lo, hi = ranges[k]
        out[n] = lo + (hi - lo) * part
    return out


def _bn(x, w, name):
    return F.batch_norm(x, w[f"{name}.running_mean"], w[f"{name}.running_var"],
                        w[f"{name}.weight"], w[f"{name}.bias"], False, 0.0, 1e-5)


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor,
            cast: Optional[Callable] = None) -> torch.Tensor:
    """x (N, 3, H, W) normalized float32 -> (N, 2048). `cast`, when given,
    rounds every convolution's input and weight (a lower precision's
    control)."""
    def conv(t, name, stride=1, padding=0):
        wt = w[name]
        if cast is not None:
            t, wt = cast(t), cast(wt)
        return F.conv2d(t, wt, stride=stride, padding=padding)

    x = F.relu(_bn(conv(x, "conv1.weight", 2, 3), w, "bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    for s, blocks in enumerate(STAGES):
        for b in range(blocks):
            p = f"layer{s + 1}.{b}"
            stride = 2 if s > 0 and b == 0 else 1
            y = F.relu(_bn(conv(x, f"{p}.conv1.weight"), w, f"{p}.bn1"))
            y = F.relu(_bn(conv(y, f"{p}.conv2.weight", stride, 1), w, f"{p}.bn2"))
            y = _bn(conv(y, f"{p}.conv3.weight"), w, f"{p}.bn3")
            if b == 0:
                x = _bn(conv(x, f"{p}.downsample.0.weight", stride), w, f"{p}.downsample.1")
            x = F.relu(y + x)
    return x.mean(dim=(2, 3))
