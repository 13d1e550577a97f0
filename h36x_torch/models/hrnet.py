"""HRNet-W48-C (Wang et al., "Deep High-Resolution Representation Learning
for Visual Recognition", TPAMI 2020, arXiv:1908.07919), the backbone whose
pooled 2048-D feature CLIFF (Li et al., ECCV 2022, arXiv:2208.00571) feeds
its regressor, as a per-frame feature backbone for extraction.

The equations are those of HRNet-Image-Classification's `cls_hrnet.py`
with its W48 configuration:

- stem: conv 3x3 s2 (3 -> 64), BN, ReLU, conv 3x3 s2 (64 -> 64), BN, ReLU
  (256 x 192 -> 64 x 48);
- stage 1: four ResNet Bottlenecks of width 64 (:class:`Bottleneck`,
  256 channels out);
- transitions: the first makes branches of 48 channels (conv 3x3) and 96
  (conv 3x3 s2) from stage 1; each later one adds a branch, conv 3x3 s2
  from the last branch; each conv with BN and ReLU;
- stages 2, 3 and 4: 1, 4 and 3 modules over 2, 3 and 4 branches of 48,
  96, 192 and 384 channels at 64 x 48, 32 x 24, 16 x 12 and 8 x 6. A
  module runs 4 BasicBlocks on each branch, then fuses: output i is
  ReLU(sum over j of f_ij(x_j)), f_ii the identity, f_ij for j > i a conv
  1x1 (c_j -> c_i) and BN upsampled (nearest) by 2^(j-i), f_ij for j < i
  i - j convs 3x3 s2 with BN, ReLU between them (the intermediate ones keep
  c_j, the last maps to c_i); 62 cross-resolution paths a forward;
- head (the "C" variant): each branch through a Bottleneck of width 32,
  64, 128 and 256; y = incre_0(x_0), then y = incre_i(x_i) +
  downsamp_{i-1}(y) with downsamp a conv 3x3 s2 (bias), BN, ReLU; then
  final_layer, a conv 1x1 (bias, 1024 -> 2048), BN, ReLU.

The feature is the mean of final_layer's 8 x 6 positions, what CLIFF's
regressor reads; the ImageNet classifier is left out (75,420,864
parameters). Extraction hands the model square crops of `img_size[0]`
pixels and the model reads their middle `img_size[1]` columns
(:class:`h36x_torch.models.crops.CropReader`, as the ViT-H backbone).

Precision: weights and activations in the module's dtype (bfloat16 for
extraction), every conv, BN (its running statistics), ReLU, upsample and
sum there, channels_last; the normalization before the cast and the final
mean are float32, and the features are returned as float32. The convs
and BNs are cuDNN's on the card.

Parameter names are `cls_hrnet.py`'s (`conv1`, `bn1`, `layer1.0.conv1`,
`transition1.1.0.0`, `stage3.2.branches.1.3.conv2`,
`stage4.0.fuse_layers.3.0.2.1`, `incre_modules.0.0.downsample.0`,
`downsamp_modules.2.0`, `final_layer.0`, ...), so a checkpoint of that
layout loads as it is, with or without a prefix that a wrapping model adds
(:func:`load_hrnet`). The module is built on the `meta` device and
materialized by the load; :func:`random_hrnet` draws seeded weights where
no file is given.

Spans and counters (:mod:`h36x_torch.utils.profiling`), one roofline unit
each: `h36x.hrnet.stem` (the column read, normalization, stem and stage
1), `h36x.hrnet.transition` (each transition), `h36x.hrnet.branches` (a
module's BasicBlocks on all its branches), `h36x.hrnet.fuse` (a module's
exchange), `h36x.hrnet.head` (incre, downsamp, final layer and mean); the
counters `h36x.hrnet.frames` (frames entering) and `h36x.hrnet.fuse_paths`
(cross-resolution paths run).
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from h36x_torch.models.crops import CropReader
from h36x_torch.models.resnet import Bottleneck
from h36x_torch.utils.profiling import count, span

# HRNet-W48-C at its published widths, on CLIFF's 256 x 192 crops
HRNET_W48 = dict(img_size=(256, 192), stem=64, stage1_blocks=4, stage1_width=64,
                 channels=(48, 96, 192, 384), modules=(1, 4, 3), blocks=4,
                 head=(32, 64, 128, 256), feature=2048, eps=1e-5)


def _conv_bn(c_in, c_out, k=3, stride=1, relu=True, bias=False):
    layers = [nn.Conv2d(c_in, c_out, k, stride, k // 2, bias=bias), nn.BatchNorm2d(c_out)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


class BasicBlock(nn.Module):
    """3x3, BN, ReLU, 3x3, BN, plus the input, then ReLU."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(c)
        self.conv2 = nn.Conv2d(c, c, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(c)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + x)


def _fuse_path(channels, i: int, j: int):
    """f_ij: branch j's stream brought to branch i's width and size."""
    if j == i:
        return None
    if j > i:
        return nn.Sequential(nn.Conv2d(channels[j], channels[i], 1, bias=False),
                             nn.BatchNorm2d(channels[i]),
                             nn.Upsample(scale_factor=2 ** (j - i), mode="nearest"))
    steps = [_conv_bn(channels[j], channels[j], stride=2) for _ in range(i - j - 1)]
    return nn.Sequential(*steps, _conv_bn(channels[j], channels[i], stride=2, relu=False))


class HighResolutionModule(nn.Module):
    """`blocks` BasicBlocks on each branch, then the exchange."""

    def __init__(self, channels, blocks: int):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(c) for _ in range(blocks))) for c in channels)
        self.fuse_layers = nn.ModuleList(
            nn.ModuleList(_fuse_path(channels, i, j) for j in range(n)) for i in range(n))

    def forward(self, xs):
        n = len(xs)
        with span("h36x.hrnet.branches"):
            xs = [branch(x) for branch, x in zip(self.branches, xs)]
        with span("h36x.hrnet.fuse"):
            out = []
            for i, paths in enumerate(self.fuse_layers):
                y = xs[0] if i == 0 else paths[0](xs[0])
                for j in range(1, n):
                    y = y + (xs[j] if j == i else paths[j](xs[j]))
                out.append(torch.relu(y))
        count("h36x.hrnet.fuse_paths", n * (n - 1))
        return out


def _transition(pre, cur):
    """cls_hrnet.py's transition: a conv where a kept branch changes width,
    and each new branch a chain of strided convs from the last one."""
    layers = []
    for i, c in enumerate(cur):
        if i < len(pre):
            layers.append(_conv_bn(pre[i], c) if c != pre[i] else None)
        else:
            steps = [_conv_bn(pre[-1], pre[-1], stride=2) for _ in range(i - len(pre))]
            layers.append(nn.Sequential(*steps, _conv_bn(pre[-1], c, stride=2)))
    return nn.ModuleList(layers)


class HRNet(CropReader, nn.Module):
    """HRNet-C's backbone: (N, S, S, 3) uint8 square crops, S = img_size[0]
    -> (N, feature) float32 means of the final layer (:meth:`forward`), the
    middle img_size[1] columns read."""

    backbone_name = "hrnet_w48"

    def __init__(self, img_size=HRNET_W48["img_size"], stem=HRNET_W48["stem"],
                 stage1_blocks=HRNET_W48["stage1_blocks"],
                 stage1_width=HRNET_W48["stage1_width"], channels=HRNET_W48["channels"],
                 modules=HRNET_W48["modules"], blocks=HRNET_W48["blocks"],
                 head=HRNET_W48["head"], feature=HRNET_W48["feature"], eps=HRNET_W48["eps"],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.img_size = tuple(int(s) for s in img_size)
        if any(s % 32 for s in self.img_size):
            raise ValueError(f"HRNet reads sides that are multiples of 32 (five exact 2x "
                             f"steps); img_size is {self.img_size}")
        channels, head = tuple(channels), tuple(head)
        if len(modules) != len(channels) - 1 or len(head) != len(channels):
            raise ValueError(f"{len(channels)} branches need {len(channels) - 1} stages of "
                             f"modules and {len(channels)} head widths")
        self.feature, self.dtype = int(feature), dtype
        self.n_stages = len(modules)
        with torch.device("meta"):  # materialized by load_hrnet or random_hrnet
            self.conv1 = nn.Conv2d(3, stem, 3, 2, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(stem)
            self.conv2 = nn.Conv2d(stem, stem, 3, 2, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(stem)
            width = 4 * stage1_width
            self.layer1 = nn.Sequential(
                Bottleneck(stem, stage1_width),
                *(Bottleneck(width, stage1_width) for _ in range(stage1_blocks - 1)))
            pre = (width,)
            for s, n_modules in enumerate(modules, start=2):
                cur = channels[:s]
                setattr(self, f"transition{s - 1}", _transition(pre, cur))
                setattr(self, f"stage{s}", nn.Sequential(
                    *(HighResolutionModule(cur, blocks) for _ in range(n_modules))))
                pre = cur
            self.incre_modules = nn.ModuleList(
                nn.Sequential(Bottleneck(c, w)) for c, w in zip(channels, head))
            self.downsamp_modules = nn.ModuleList(
                _conv_bn(4 * head[i], 4 * head[i + 1], stride=2, bias=True)
                for i in range(len(head) - 1))
            self.final_layer = _conv_bn(4 * head[-1], feature, k=1, bias=True)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.eps = eps
        self.to(dtype)
        self.requires_grad_(False)
        super().train(False)

    def train(self, mode: bool = True):
        """Inference only: BatchNorm keeps its running statistics."""
        return super().train(False)

    def forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        count("h36x.hrnet.frames", int(frames_u8.shape[0]))
        with span("h36x.hrnet.stem"):
            x = frames_u8[:, :, self.columns(int(frames_u8.shape[1]))]
            # an NHWC tensor seen as NCHW is channels_last: no copy
            x = self.normalize(x).to(self.dtype).permute(0, 3, 1, 2)
            x = torch.relu(self.bn1(self.conv1(x)))
            x = torch.relu(self.bn2(self.conv2(x)))
            xs = [self.layer1(x)]
        for s in range(2, self.n_stages + 2):
            with span("h36x.hrnet.transition"):
                xs = [xs[min(i, len(xs) - 1)] if t is None else t(xs[min(i, len(xs) - 1)])
                      for i, t in enumerate(getattr(self, f"transition{s - 1}"))]
            for module in getattr(self, f"stage{s}"):
                xs = module(xs)
        with span("h36x.hrnet.head"):
            y = self.incre_modules[0](xs[0])
            for i in range(1, len(xs)):
                y = self.incre_modules[i](xs[i]) + self.downsamp_modules[i - 1](y)
            return self.final_layer(y).mean(dim=(2, 3), dtype=torch.float32)


def _strip_prefix(state_dict: dict) -> dict:
    """The keys of the one prefix under which `final_layer` lies (none, or
    a wrapping model's, e.g. `encoder.` or `backbone.`) without it, the
    classifier left out."""
    tail = "final_layer.1.running_var"
    prefixes = {k[:-len(tail)] for k in state_dict if k.endswith(tail)}
    prefix = prefixes.pop() if len(prefixes) == 1 else ""
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix) and not k[len(prefix):].startswith("classifier.")}


def load_hrnet(model: HRNet, state_dict: dict, device) -> HRNet:
    """Materialize `model` (built on `meta`) on `device` in its dtype,
    channels_last, from a `cls_hrnet.py`-layout state_dict: with or without
    a wrapping model's prefix, `classifier.*` left out. Every other key and
    shape must match; BatchNorm's `num_batches_tracked` may be left out,
    and is 0 (inference reads none). The floating tensors (1,629 at W48's
    widths) are cast on the host into one buffer, which crosses to the
    device in one copy."""
    sd = _strip_prefix(state_dict)
    own = model.state_dict()
    floats = [k for k, v in own.items() if v.is_floating_point()]
    missing = sorted(set(floats) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    wrong = sorted(k for k in set(own) & set(sd) if tuple(own[k].shape) != tuple(sd[k].shape))
    if missing or unexpected or wrong:
        raise KeyError(f"not this HRNet's state_dict: missing {missing[:5]}, unexpected "
                       f"{unexpected[:5]}, other shapes {wrong[:5]}")
    device = torch.device(device)
    flat = torch.cat([sd[k].reshape(-1).to(model.dtype) for k in floats]).to(device)
    parts = flat.split([own[k].numel() for k in floats])
    full = {k: part.view(own[k].shape) for k, part in zip(floats, parts)}
    steps = [k for k in own if k not in full]
    full.update(zip(steps, torch.zeros(len(steps), dtype=torch.long, device=device)))
    model.load_state_dict(full, assign=True)
    return model.to(memory_format=torch.channels_last).requires_grad_(False)


def load_hrnet_file(model: HRNet, path, device) -> HRNet:
    """:func:`load_hrnet` from a torch.save'd file (a bare state_dict or
    {"state_dict": ...}), mapped from disk rather than read whole."""
    raw = torch.load(Path(path), map_location="cpu", weights_only=True, mmap=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return load_hrnet(model, raw, device)


def random_hrnet(device, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                 **sizes) -> HRNet:
    """An HRNet with `cls_hrnet.py`'s init drawn on `device` from `seed`:
    conv weights N(0, 2 / fan_out), conv biases 0, BatchNorm 1 and 0 with
    running statistics 0 and 1."""
    model = HRNet(dtype=dtype, **sizes)
    model.to_empty(device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.copy_(torch.randn(m.weight.shape, generator=g, device=device)
                               * (2.0 / fan_out) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model.to(memory_format=torch.channels_last)


def backbone(weights: str, device) -> HRNet:
    """Extraction's HRNet-W48 at :data:`HRNET_W48`'s widths on `device`: from
    a `cls_hrnet.py`-layout file, or seeded where `weights` is ""."""
    if not weights:
        return random_hrnet(device, **HRNET_W48)
    return load_hrnet_file(HRNet(**HRNET_W48), weights, device)
