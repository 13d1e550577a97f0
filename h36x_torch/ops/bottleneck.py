"""Fused ResNet bottleneck block, inference, BatchNorm folded (counterpart
of h36x/ops/pallas_bottleneck.py):

    out = relu( relu(conv3x3(relu(x @ W1 + b1)) + b2) @ W3 + b3 + res )

where res is x itself (identity blocks) or x @ Wp + bp (projection), the
frozen BatchNorms folded into the conv weights and biases
(:func:`fold_bn_params`). Activations are (B, H*W, C) rows, the memory
order of an NHWC tensor (and of a channels_last NCHW one).

- :func:`reference_bottleneck` is the plain PyTorch version.
- :func:`fused_bottleneck` is the wrapper of the CUDA kernel
  `csrc/bottleneck.cu` (kernel B5): on a CUDA tensor it launches the
  kernel on the route :func:`bottleneck_route` picks from the dtype and
  the widths and counts the launch in `fused_bottleneck.launches` (and in
  `fused_bottleneck.launches_by_route`); on a CPU tensor it runs the plain
  version; on any other device it raises.
- :func:`launch_on_route` launches one named route, uncounted, to time
  the two routes on the same inputs.

The routes: "hopper" (TMA + wgmma, bfloat16 with C_in, C_mid and C_out
multiples of 64: all 13 stride-1 blocks of ResNet-50) and "general" (the
first design: float32, the fp32-accuracy mode, and any other widths).

Both round where the TPU kernel rounds: weights folded in f32 then cast to
x's dtype, biases kept in f32, products accumulated in f32, `a` and `b`
rounded to x's dtype after their ReLU, c + res summed in f32 (an identity
residual upcast from x), the output rounded once.

The folded weights keep h36x's layouts, so the two packages' folds compare
directly: 1x1 kernels as (C_in, C_out) matrices, the 3x3 as HWIO
(3, 3, C, C), the stem as HWIO (7, 7, 3, 64).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from h36x_torch.ops import _build

STAGE_SIZES = (3, 4, 6, 3)  # ResNet-50
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("general", "hopper")  # index = the entry point's route code
HOPPER_WIDTH = 64  # the Hopper route's K step and narrowest tile


def _np32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def fold_bn_params(conv_kernel, bn_scale, bn_bias, bn_mean, bn_var,
                   eps: float = 1e-5):
    """Fold a frozen BatchNorm into the preceding conv: BN(conv(x)) =
    conv(x) * g + (beta - mean * g) with g = gamma / sqrt(var + eps).

    conv_kernel is HWIO (or (C_in, C_out)), its last axis the output
    channels. Returns (kernel', bias') as float32 tensors, computed in
    numpy float32 exactly as h36x computes them."""
    g = _np32(bn_scale) / np.sqrt(_np32(bn_var) + eps)
    kernel = _np32(conv_kernel) * g
    bias = _np32(bn_bias) - _np32(bn_mean) * g
    return torch.from_numpy(kernel), torch.from_numpy(bias)


def _hwio(weight) -> np.ndarray:
    """A torch conv weight (O, I, kh, kw) as an HWIO kernel."""
    return np.transpose(_np32(weight), (2, 3, 1, 0))


def _fold_conv_bn(sd: dict, conv: str, bn: str, eps: float):
    return fold_bn_params(_hwio(sd[f"{conv}.weight"]), sd[f"{bn}.weight"],
                          sd[f"{bn}.bias"], sd[f"{bn}.running_mean"],
                          sd[f"{bn}.running_var"], eps)


def fold_bottleneck(block, eps: float = 1e-5) -> dict:
    """A Bottleneck (module, or its state dict with torchvision's names) ->
    {w1, b1, w2, b2, w3, b3[, wp, bp]}: 1x1 kernels as (C_in, C_out), the
    3x3 as HWIO (3, 3, C, C), all float32."""
    sd = block.state_dict() if isinstance(block, torch.nn.Module) else block
    out = {}
    for conv, bn, name in (("conv1", "bn1", "w1"), ("conv2", "bn2", "w2"),
                           ("conv3", "bn3", "w3")):
        k, b = _fold_conv_bn(sd, conv, bn, eps)
        out[name] = k if name == "w2" else k.reshape(k.shape[2], k.shape[3])
        out[name.replace("w", "b")] = b
    if "downsample.0.weight" in sd:
        k, b = _fold_conv_bn(sd, "downsample.0", "downsample.1", eps)
        out["wp"] = k.reshape(k.shape[2], k.shape[3])
        out["bp"] = b
    return out


def fold_resnet50(model, eps: float = 1e-5):
    """A ResNet50 (module, or its state dict) -> ({"layer{L}_{B}": folded
    block}, (stem kernel HWIO, stem bias)), h36x's block names."""
    sd = model.state_dict() if isinstance(model, torch.nn.Module) else model
    folded = {}
    for stage, num_blocks in enumerate(STAGE_SIZES, start=1):
        for block in range(num_blocks):
            prefix = f"layer{stage}.{block}."
            folded[f"layer{stage}_{block}"] = fold_bottleneck(
                {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)},
                eps)
    return folded, _fold_conv_bn(sd, "conv1", "bn1", eps)


def prepare_bottleneck(folded: dict, dtype: torch.dtype, device) -> dict:
    """The folded weights as the kernel and the plain version take them:
    weights cast to `dtype` (rounded once from the f32 fold), biases f32,
    the 3x3 as a (9*C_mid, C_mid) matrix in (dy, dx, c_in) row order, and
    for projection blocks [W3; Wp] stacked with b3 + bp, on `device`. Both
    routes read w1, w2_mat and w3p as they lie, (K, N) row-major.
    A dict prepared for this dtype and device comes back as it is."""
    want = torch.device(device)
    have_dtype, have_dev = folded.get("_prepared_for", (None, None))
    if have_dtype == dtype and have_dev.type == want.type and \
            want.index in (None, have_dev.index):
        return folded

    def f32(name):
        v = folded[name]
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(_np32(v))
        return v.to(device=device, dtype=torch.float32)

    out = {name: f32(name).to(dtype).contiguous()
           for name in ("w1", "w2", "w3", "wp") if name in folded}
    out.update({name: f32(name).contiguous()
                for name in ("b1", "b2", "b3", "bp") if name in folded})
    c_mid = out["w1"].shape[1]
    out["w2_mat"] = out["w2"].reshape(9 * c_mid, c_mid)
    if "wp" in out:
        out["w3p"] = torch.cat([out["w3"], out["wp"]]).contiguous()
        out["b3p"] = out["b3"] + out["bp"]
    else:
        out["w3p"], out["b3p"] = out["w3"], out["b3"]
    out["_prepared_for"] = (dtype, out["w1"].device)
    return out


def conv_nhwc(x, w_hwio, stride: int = 1, padding=0):
    """NHWC convolution with an HWIO kernel (cuDNN on the card; x in
    channels_last memory order, no copy of x)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def max_pool_nhwc(x):
    """3x3 / stride-2 max pool over an image padded with -inf (torch's
    MaxPool2d(3, 2, padding=1)), NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def reference_bottleneck(x: torch.Tensor, folded: dict, h: int, w: int) -> torch.Tensor:
    """Plain version: x (B, H*W, C_in) -> (B, H*W, C_out) in x's dtype,
    every product in float32 on operands rounded to x's dtype."""
    dt = x.dtype
    p = prepare_bottleneck(folded, dt, x.device)
    b, hw, _ = x.shape
    c_mid = p["w1"].shape[1]
    xf = x.float()
    a = torch.relu(xf @ p["w1"].float() + p["b1"]).to(dt)
    m = conv_nhwc(a.float().reshape(b, h, w, c_mid), p["w2"].float(), padding=1)
    bb = torch.relu(m.reshape(b, hw, c_mid) + p["b2"]).to(dt)
    c = bb.float() @ p["w3"].float() + p["b3"]
    res = xf @ p["wp"].float() + p["bp"] if "wp" in p else xf
    return torch.relu(c + res).to(dt)


def bottleneck_route(dtype: torch.dtype, c_in: int, c_mid: int, c_out: int) -> str:
    """The kernel route of a block: "hopper" for bfloat16 with every width a
    multiple of 64, else "general". A function of these four alone, decided
    before the launch."""
    if dtype == torch.bfloat16 and all(c % HOPPER_WIDTH == 0 for c in (c_in, c_mid, c_out)):
        return "hopper"
    return "general"


def _launch(x: torch.Tensor, p: dict, h: int, w: int) -> torch.Tensor:
    route = bottleneck_route(x.dtype, x.shape[2], p["w1"].shape[1], p["w3"].shape[1])
    out = launch_on_route(x, p, h, w, route)
    fused_bottleneck.launches += 1
    fused_bottleneck.launches_by_route[route] += 1
    return out


def launch_on_route(x: torch.Tensor, p: dict, h: int, w: int, route: str) -> torch.Tensor:
    """The kernel on the named route, x on the card and `p` prepared for it,
    uncounted: for timing one route against the other on the same inputs.
    :func:`fused_bottleneck` is the entry point, and takes the route
    :func:`bottleneck_route` names."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_bottleneck: x is {x.dtype}, expected float32 "
                        "or bfloat16")
    if not x.is_contiguous():
        raise ValueError("fused_bottleneck: x must be contiguous (B, H*W, C) "
                         "rows (an NHWC or channels_last tensor)")
    b, hw, c_in = x.shape
    c_mid, c_out = p["w1"].shape[1], p["w3"].shape[1]
    has_proj = "wp" in p
    if p["w1"].shape[0] != c_in or (not has_proj and c_in != c_out):
        raise ValueError(f"fused_bottleneck: folded weights (w1 {tuple(p['w1'].shape)}, "
                         f"w3 {tuple(p['w3'].shape)}, projection {has_proj}) do not "
                         f"fit C_in={c_in}")
    if route == "hopper" and x.data_ptr() % 16:
        raise ValueError("fused_bottleneck: x must be 16-byte aligned on the "
                         "hopper route (its rows load by TMA)")
    dev = x.device
    a_ws = torch.empty((b * hw, c_mid), device=dev, dtype=x.dtype)
    b_ws = torch.empty((b * hw, c_mid), device=dev, dtype=x.dtype)
    out = torch.empty((b, hw, c_out), device=dev, dtype=x.dtype)
    (lib,) = _build.load("bottleneck")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.h36x_fused_bottleneck(
            x.data_ptr(), p["w1"].data_ptr(), p["b1"].data_ptr(),
            p["w2_mat"].data_ptr(), p["b2"].data_ptr(), p["w3p"].data_ptr(),
            p["b3p"].data_ptr(), a_ws.data_ptr(), b_ws.data_ptr(), out.data_ptr(),
            b, h, w, c_in, c_mid, c_out, int(has_proj), _DTYPE_CODES[x.dtype],
            ROUTES.index(route), stream)
    # an empty batch is refused (on the general route: a grid of 0 blocks)
    _build.check(rc, f"fused_bottleneck ({route}, B={b}, H={h}, W={w}, C_in={c_in})")
    return out


def fused_bottleneck(x: torch.Tensor, folded: dict, h: int, w: int) -> torch.Tensor:
    """x (B, H*W, C_in) bfloat16 or float32 -> (B, H*W, C_out) in x's dtype;
    stride-1 blocks, identity or projection residual. `folded` is a
    :func:`fold_bottleneck` dict or one :func:`prepare_bottleneck` made."""
    if x.ndim != 3 or x.shape[1] != h * w:
        raise ValueError(f"fused_bottleneck: x {tuple(x.shape)} is not "
                         f"(B, H*W={h * w}, C)")
    if x.device.type == "cpu":
        return reference_bottleneck(x, folded, h, w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck runs on cuda or cpu, not {x.device}")
    return _launch(x, prepare_bottleneck(folded, x.dtype, x.device), h, w)


fused_bottleneck.launches = 0  # kernel launches on CUDA tensors, every route
fused_bottleneck.launches_by_route = dict.fromkeys(ROUTES, 0)


def transition_block(y: torch.Tensor, f: dict) -> torch.Tensor:
    """A stride-2 transition block, plain PyTorch (folded BN: conv + bias +
    ReLU), NHWC in and out, in y's dtype."""
    dt = y.dtype
    a = torch.relu(y @ f["w1"].to(dt) + f["b1"].to(dt))
    m = torch.relu(conv_nhwc(a, f["w2"].to(dt), stride=2, padding=1) + f["b2"].to(dt))
    c = m @ f["w3"].to(dt) + f["b3"].to(dt)
    res = y[:, ::2, ::2, :] @ f["wp"].to(dt) + f["bp"].to(dt)
    return torch.relu(c + res)


def stride1_block(y: torch.Tensor, f: dict) -> torch.Tensor:
    """A stride-1 block through :func:`fused_bottleneck`, NHWC in and out."""
    n, side, _, c = y.shape
    out = fused_bottleneck(y.reshape(n, side * side, c), f, h=side, w=side)
    return out.reshape(n, side, side, out.shape[-1])


def resnet50_fused_forward(x: torch.Tensor, folded: dict, stem) -> torch.Tensor:
    """Headless ResNet-50 with every stride-1 block one fused_bottleneck
    call (13 per forward). x: (N, H, W, 3) normalized bfloat16/float32
    input; the stem conv, max pool and the 3 stride-2 transitions are plain
    PyTorch. Returns (N, 2048) float32 pooled features."""
    dt = x.dtype
    stem_k, stem_b = stem
    stem_k = torch.as_tensor(stem_k).to(x.device, dt)
    stem_b = torch.as_tensor(stem_b).to(x.device, dt)
    y = torch.relu(conv_nhwc(x, stem_k, stride=2, padding=3) + stem_b)
    y = max_pool_nhwc(y)
    for stage, num_blocks in enumerate(STAGE_SIZES, start=1):
        for block in range(num_blocks):
            f = prepare_bottleneck(folded[f"layer{stage}_{block}"], dt, x.device)
            y = transition_block(y, f) if stage > 1 and block == 0 else stride1_block(y, f)
    return y.mean(dim=(1, 2)).float()
