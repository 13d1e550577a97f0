"""The plain reference of HRNet-W48-C (arXiv:1908.07919; CLIFF's backbone,
arXiv:2208.00571) for the CPU tests: plain float32 PyTorch, NCHW,
`F.conv2d`, batch norm from its running statistics, nearest upsampling;
nothing of the port and no JAX.

Equations as HRNet-Image-Classification's `cls_hrnet.py` writes them: a
stem of two 3x3 stride-2 convs, stage 1 of Bottlenecks, then stages of
modules over 2, 3 and 4 branches. A transition makes each new branch from
the last one (3x3 stride 2); a module runs BasicBlocks on each branch and
then fuses: output i is ReLU(sum over j of f_ij(x_j)), f_ii the identity,
f_ij for j > i a 1x1 conv and BN then a nearest upsample by 2^(j-i), f_ij
for j < i a chain of i - j 3x3 stride-2 convs with BN, ReLU after all but
the last. The "C" head: a Bottleneck on each branch, y = incre_0(x_0), y =
incre_i(x_i) + downsamp(y) (3x3 stride 2 with bias, BN, ReLU), the final
layer a 1x1 conv with bias, BN, ReLU. The feature is the mean of the final
layer's positions (CLIFF's regressor input; the classifier is left out);
the input is a square uint8 crop of img_size[0] pixels whose middle
img_size[1] columns are read, ImageNet-normalized.

Weights are a `cls_hrnet.py`-named state_dict; :func:`make_weights` draws
them as portbench/reference/hrnet_w48.py does (the two are held equal by
the benchmark's tests).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def fuse_paths(s: dict) -> int:
    """The cross-resolution paths of a forward: n (n - 1) a module of n
    branches."""
    return sum(m * n * (n - 1) for n, m in enumerate(s["modules"], start=2))


def _conv(name, c_out, c_in, k, bias=False):
    out = [(f"{name}.weight", (c_out, c_in, k, k), "conv")]
    return out + [(f"{name}.bias", (c_out,), "bias")] if bias else out


def _bn(name, c, gamma="gamma"):
    return [(f"{name}.weight", (c,), gamma), (f"{name}.bias", (c,), "beta"),
            (f"{name}.running_mean", (c,), "mean"), (f"{name}.running_var", (c,), "var")]


def _bottleneck(p, c_in, width):
    specs = (_conv(f"{p}.conv1", width, c_in, 1) + _bn(f"{p}.bn1", width)
             + _conv(f"{p}.conv2", width, width, 3) + _bn(f"{p}.bn2", width)
             + _conv(f"{p}.conv3", 4 * width, width, 1) + _bn(f"{p}.bn3", 4 * width, "residual"))
    if c_in != 4 * width:
        specs += _conv(f"{p}.downsample.0", 4 * width, c_in, 1) + _bn(f"{p}.downsample.1",
                                                                       4 * width)
    return specs


def _branch_inputs(s: dict, stage: int) -> tuple:
    """The widths entering stage `stage`'s transition."""
    return (4 * s["stage1_width"],) if stage == 2 else s["channels"][:stage - 1]


def param_specs(s: dict) -> List[tuple]:
    """(name, shape, kind) of every tensor; kind "conv" (N(0, 2 / fan_out)),
    "bias" (a conv's), or a batch norm's "gamma", "residual" (the last norm
    of a residual branch), "fuse" (the last norm of a fusion path), "beta",
    "mean", "var"."""
    stem, ch = s["stem"], s["channels"]
    specs = (_conv("conv1", stem, 3, 3) + _bn("bn1", stem)
             + _conv("conv2", stem, stem, 3) + _bn("bn2", stem))
    c_in = stem
    for b in range(s["stage1_blocks"]):
        specs += _bottleneck(f"layer1.{b}", c_in, s["stage1_width"])
        c_in = 4 * s["stage1_width"]
    for st, n_modules in enumerate(s["modules"], start=2):
        pre, cur = _branch_inputs(s, st), ch[:st]
        for i, c in enumerate(cur):
            t = f"transition{st - 1}.{i}"
            if i < len(pre):
                if c != pre[i]:
                    specs += _conv(f"{t}.0", c, pre[i], 3) + _bn(f"{t}.1", c)
                continue
            for k in range(i - len(pre) + 1):
                out = c if k == i - len(pre) else pre[-1]
                specs += _conv(f"{t}.{k}.0", out, pre[-1], 3) + _bn(f"{t}.{k}.1", out)
        for m in range(n_modules):
            p = f"stage{st}.{m}"
            for i, c in enumerate(cur):
                for b in range(s["blocks"]):
                    q = f"{p}.branches.{i}.{b}"
                    specs += (_conv(f"{q}.conv1", c, c, 3) + _bn(f"{q}.bn1", c)
                              + _conv(f"{q}.conv2", c, c, 3) + _bn(f"{q}.bn2", c, "residual"))
            for i in range(st):
                for j in range(st):
                    f = f"{p}.fuse_layers.{i}.{j}"
                    if j > i:
                        specs += _conv(f"{f}.0", ch[i], ch[j], 1) + _bn(f"{f}.1", ch[i], "fuse")
                    for k in range(i - j):
                        last = k == i - j - 1
                        out = ch[i] if last else ch[j]
                        specs += _conv(f"{f}.{k}.0", out, ch[j], 3) + _bn(
                            f"{f}.{k}.1", out, "fuse" if last else "gamma")
    head = s["head"]
    for i, (c, w) in enumerate(zip(ch, head)):
        specs += _bottleneck(f"incre_modules.{i}.0", c, w)
    for i in range(len(head) - 1):
        specs += (_conv(f"downsamp_modules.{i}.0", 4 * head[i + 1], 4 * head[i], 3, bias=True)
                  + _bn(f"downsamp_modules.{i}.1", 4 * head[i + 1]))
    specs += (_conv("final_layer.0", s["feature"], 4 * head[-1], 1, bias=True)
              + _bn("final_layer.1", s["feature"]))
    return specs


def make_weights(s: dict, generator: torch.Generator, device="cpu") -> Dict[str, torch.Tensor]:
    """Convs from N(0, 2 / fan_out) (`cls_hrnet.py`'s init); batch norm's
    gamma U(0.8, 1.2), but small on the last norm of each fusion path,
    U(0.2, 0.4), and of each residual branch, U(0.05, 0.1): trained
    networks keep those small, and the norms here do not normalize, so with
    larger ones the sums of up to four streams, 36 residual blocks deep,
    grow without bound (U(0.2, 0.4) on both puts stage 4 at 46 to 89 times
    stage 1's RMS at the published widths; these keep every stage within
    0.6 to 7 times the stem's). Beta, running mean and conv biases
    U(-0.1, 0.1); running var U(0.8, 1.2). Two draws: one normal for every
    conv, one uniform for the rest."""
    specs = param_specs(s)
    convs = [(n, sh) for n, sh, k in specs if k == "conv"]
    other = [(n, sh, k) for n, sh, k in specs if k != "conv"]
    counts = [math.prod(sh) for _, sh in convs]
    z = torch.randn(sum(counts), generator=generator, device=device)
    out = {n: part.reshape(sh) * (2.0 / (sh[0] * sh[2] * sh[3])) ** 0.5
           for (n, sh), part in zip(convs, torch.split(z, counts))}
    ranges = {"gamma": (0.8, 1.2), "residual": (0.05, 0.1), "fuse": (0.2, 0.4),
              "beta": (-0.1, 0.1), "mean": (-0.1, 0.1), "bias": (-0.1, 0.1),
              "var": (0.8, 1.2)}
    counts = [math.prod(sh) for _, sh, _ in other]
    u = torch.rand(sum(counts), generator=generator, device=device)
    for (n, sh, k), part in zip(other, torch.split(u, counts)):
        lo, hi = ranges[k]
        out[n] = (lo + (hi - lo) * part).reshape(sh)
    return out


def forward(w: Dict[str, torch.Tensor], crops_u8: torch.Tensor, s: dict,
            cast: Optional[Callable] = None,
            tap: Optional[Callable] = None) -> torch.Tensor:
    """(N, S, S, 3) uint8 square crops, S = img_size[0] -> (N, feature)
    float32. `cast`, when given, rounds both operands of every convolution
    (a lower precision's control); `tap(name, streams)`, when given, sees
    the streams after the stem ("stem"), stage 1 ("stage1"), each later
    stage ("stage2", ...) and the final layer ("head")."""
    c = cast if cast is not None else (lambda t: t)
    eps = s["eps"]

    def conv(x, name, stride=1, bias=False):
        k = w[f"{name}.weight"]
        return F.conv2d(c(x), c(k), w[f"{name}.bias"] if bias else None, stride,
                        k.shape[-1] // 2)

    def bn(x, name):
        return F.batch_norm(x, w[f"{name}.running_mean"], w[f"{name}.running_var"],
                            w[f"{name}.weight"], w[f"{name}.bias"], False, 0.0, eps)

    def conv_bn(x, p, stride=1, relu=True, bias=False):
        y = bn(conv(x, f"{p}.0", stride, bias), f"{p}.1")
        return F.relu(y) if relu else y

    def bottleneck(x, p):
        y = F.relu(bn(conv(x, f"{p}.conv1"), f"{p}.bn1"))
        y = F.relu(bn(conv(y, f"{p}.conv2"), f"{p}.bn2"))
        y = bn(conv(y, f"{p}.conv3"), f"{p}.bn3")
        res = x
        if x.shape[1] != y.shape[1]:  # a width change: the projected shortcut
            res = bn(conv(x, f"{p}.downsample.0"), f"{p}.downsample.1")
        return F.relu(y + res)

    def basic(x, p):
        y = F.relu(bn(conv(x, f"{p}.conv1"), f"{p}.bn1"))
        return F.relu(bn(conv(y, f"{p}.conv2"), f"{p}.bn2") + x)

    def path(x, p, i, j):
        if j > i:
            y = bn(conv(x, f"{p}.0"), f"{p}.1")
            return F.interpolate(y, scale_factor=2 ** (j - i), mode="nearest")
        for k in range(i - j):
            x = conv_bn(x, f"{p}.{k}", stride=2, relu=k < i - j - 1)
        return x

    see = tap if tap is not None else (lambda name, streams: None)
    h, wd = s["img_size"]
    left = (h - wd) // 2
    x = crops_u8[:, :, left:left + wd].float() / 255.0
    x = (x - torch.tensor(MEAN, device=x.device)) / torch.tensor(STD, device=x.device)
    x = x.permute(0, 3, 1, 2).contiguous()
    x = F.relu(bn(conv(x, "conv1", 2), "bn1"))
    x = F.relu(bn(conv(x, "conv2", 2), "bn2"))
    see("stem", [x])
    for b in range(s["stage1_blocks"]):
        x = bottleneck(x, f"layer1.{b}")
    xs = [x]
    see("stage1", xs)
    for st, n_modules in enumerate(s["modules"], start=2):
        pre, cur = _branch_inputs(s, st), s["channels"][:st]
        new = []
        for i, ci in enumerate(cur):
            t = f"transition{st - 1}.{i}"
            if i < len(pre):
                new.append(conv_bn(xs[i], t) if ci != pre[i] else xs[i])
                continue
            y = xs[-1]
            for k in range(i - len(pre) + 1):
                y = conv_bn(y, f"{t}.{k}", stride=2)
            new.append(y)
        xs = new
        for m in range(n_modules):
            p = f"stage{st}.{m}"
            for i in range(st):
                for b in range(s["blocks"]):
                    xs[i] = basic(xs[i], f"{p}.branches.{i}.{b}")
            fused = []
            for i in range(st):
                y = xs[0] if i == 0 else path(xs[0], f"{p}.fuse_layers.{i}.0", i, 0)
                for j in range(1, st):
                    y = y + (xs[j] if j == i else path(xs[j], f"{p}.fuse_layers.{i}.{j}", i, j))
                fused.append(F.relu(y))
            xs = fused
        see(f"stage{st}", xs)
    y = bottleneck(xs[0], "incre_modules.0.0")
    for i in range(1, len(xs)):
        y = bottleneck(xs[i], f"incre_modules.{i}.0") + conv_bn(
            y, f"downsamp_modules.{i - 1}", stride=2, bias=True)
    y = conv_bn(y, "final_layer", bias=True)
    see("head", [y])
    return y.mean(dim=(2, 3))
