"""ResNet-50 feature backbone as nn.Modules (counterpart of
h36x/models/resnet.py): torchvision's ResNet-v1.5 (7x7/2 stem, 3x3/2 max
pool, bottleneck stages [3, 4, 6, 3] with the stride on the 3x3 conv),
headless, global-average-pooled to 2048-D.

Inference only: BatchNorm always uses its running statistics (eps 1e-5),
whatever `train()` is asked. The module runs channels_last in its dtype
(bfloat16 for extraction). Parameter names are torchvision's (`conv1`,
`bn1`, `layer1.0.conv1`, `layer1.0.downsample.0/1`, ...), so a
torchvision state_dict loads directly (:func:`load_torchvision`);
:func:`params_from_flax` maps h36x's flax variables onto the same names.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from h36x_torch.utils.runtime import resolve_device

STAGE_SIZES = (3, 4, 6, 3)  # ResNet-50


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here: v1.5) -> 1x1 with 4x expansion; NCHW."""

    def __init__(self, in_channels: int, width: int, stride: int = 1):
        super().__init__()
        out = width * 4
        self.conv1 = nn.Conv2d(in_channels, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=1e-5)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width, eps=1e-5)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out, eps=1e-5)
        self.downsample = None
        if in_channels != out or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out, eps=1e-5))

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + res)


class ResNet50(nn.Module):
    """Headless ResNet-50: (N, H, W, 3) NHWC normalized input -> (N, 2048)
    float32 pooled features.

    Weights are drawn on the CPU from `seed` with torchvision's init
    (Kaiming-normal convs, BatchNorm scale 1 and bias 0), without touching
    the global random state, then moved to `device` (cuda unless the caller
    asks for another) and `dtype`."""

    def __init__(self, dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0, stage_sizes=STAGE_SIZES):
        super().__init__()
        device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
            self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
            self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)  # pads with -inf
            in_ch = 64
            for stage, num_blocks in enumerate(stage_sizes):
                width = 64 * 2 ** stage
                blocks = []
                for block in range(num_blocks):
                    stride = 2 if stage > 0 and block == 0 else 1
                    blocks.append(Bottleneck(in_ch, width, stride))
                    in_ch = width * 4
                setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            self.n_stages = len(stage_sizes)
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")
        self.dtype = dtype
        # the float32 values behind a narrower dtype (see float32_state)
        self._f32 = None if dtype == torch.float32 else {
            k: v.detach().clone() for k, v in self.state_dict().items()}
        self.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        super().train(False)

    def train(self, mode: bool = True):
        """Inference only: BatchNorm keeps its running statistics."""
        return super().train(False)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """nn.Module's load; below float32 the float32 values are kept on
        the CPU as well (:meth:`float32_state`)."""
        result = super().load_state_dict(state_dict, strict=strict, assign=assign)
        if self._f32 is not None:
            self._f32.update({k: v.detach().to("cpu", torch.float32, copy=True)
                              for k, v in state_dict.items()
                              if k in self._f32 and v.is_floating_point()})
        return result

    def float32_state(self) -> dict:
        """The weights as float32 before their cast to `dtype`: what the
        BatchNorm fold of the `opt` engine starts from, so that a folded
        weight rounds to `dtype` once, as h36x folds its float32 params."""
        return self.state_dict() if self._f32 is None else self._f32

    def forward(self, x):
        # an NHWC tensor seen as NCHW is channels_last: no copy
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean(dim=(2, 3)).float()


def count_params(variables) -> int:
    """The number of parameters (BatchNorm's running statistics excluded):
    of a module, or of a flax variables tree's `params`."""
    if isinstance(variables, nn.Module):
        return sum(p.numel() for p in variables.parameters())

    def size(tree) -> int:
        if isinstance(tree, dict):
            return sum(size(v) for v in tree.values())
        return int(np.size(tree))

    return size(variables["params"])


def _t32(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))  # a writable copy


def _oihw(kernel) -> torch.Tensor:
    """An HWIO kernel as a torch conv weight (O, I, kh, kw)."""
    return _t32(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def params_from_flax(variables) -> dict:
    """h36x's flax ResNet50 variables {params, batch_stats} (numpy leaves,
    HWIO kernels) -> a state_dict of the port's ResNet50."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}

    def put(prefix, module, p, s):
        if "kernel" in p:
            sd[f"{prefix}.weight"] = _oihw(p["kernel"])
            return
        sd[f"{prefix}.weight"] = _t32(p["scale"])
        sd[f"{prefix}.bias"] = _t32(p["bias"])
        sd[f"{prefix}.running_mean"] = _t32(s[module]["mean"])
        sd[f"{prefix}.running_var"] = _t32(s[module]["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    put("conv1", "conv1", params["conv1"], stats)
    put("bn1", "bn1", params["bn1"], stats)
    subs = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
    for name, block in params.items():
        if not name.startswith("layer"):
            continue
        stage, idx = name[len("layer"):].split("_")
        for sub, p in block.items():
            put(f"layer{stage}.{idx}.{subs.get(sub, sub)}", sub, p, stats.get(name, {}))
    return sd


def load_torchvision(model: ResNet50, state_dict: dict) -> ResNet50:
    """Load a torchvision ResNet-50 state_dict (its `fc.*` head dropped)
    into `model`, casting to the model's dtype; every other key must match."""
    sd = {k: v for k, v in state_dict.items() if not k.startswith("fc.")}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"not a ResNet-50 state_dict: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return model


def load_torchvision_file(model: ResNet50, path) -> ResNet50:
    """Load a torch.save'd torchvision ResNet-50 state_dict file (a bare
    state_dict or {"state_dict": ...})."""
    raw = torch.load(Path(path), map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return load_torchvision(model, raw)


def backbone(weights: str, device) -> ResNet50:
    """Extraction's bfloat16 ResNet-50 on `device`: drawn from seed 0, then
    loaded from a torchvision-layout file unless `weights` is ""."""
    model = ResNet50(dtype=torch.bfloat16, device=device)
    if weights:
        load_torchvision_file(model, weights)
    return model
