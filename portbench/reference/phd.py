"""The plain reference of PHD's phase-1 model (Zhang et al., ICCV 2019,
arXiv:1908.04781; the layout of the reference code's src/model.py): plain
PyTorch, float32, written from the published description and imported by
nothing of the program.

    phi = GN->ReLU->causal conv -> dropout -> GN->ReLU->causal conv + skip,
          per f_movie block, over input_proj(features)
    y_0 = 0;  y_{i+1} = y_i + fc3(relu(fc2(dropout(relu(fc1([phi, y_i]))))))

GroupNorm takes per-sample statistics over (time, channels of the group),
eps 1e-5; the causal conv pads the past with copies of the first frame;
a conv kernel is (taps, in, out), tap k multiplying frame t - taps + 1 + k;
a dense kernel is (in, out). The loss is the mean squared error of the
joints in metres; AdamW is Loshchilov & Hutter's with b1 0.9, b2 0.999,
eps 1e-8 and decoupled weight decay.

Parameters are a flat {name: tensor} dict under the names the checkpoint
layout uses (`input_proj.kernel`, `f_movie.block0.gn1.scale`, ...).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

Params = Dict[str, torch.Tensor]


def param_specs(cfg: dict) -> List[tuple]:
    """(name, shape, low, high) of every parameter, f_AR included, in a
    fixed order; a kernel and its bias are drawn from U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), GroupNorm's scale from U(0.5, 1.5) and its bias from
    U(-0.5, 0.5) (random rather than 1 and 0, so that a scale and a bias
    taken for each other show)."""
    f, d, k = cfg["feature_dim"], cfg["latent_dim"], cfg["kernel_size"]
    h, out = cfg["regressor_hidden"], 3 * cfg["joints_num"]

    def dense(name, d_in, d_out):
        r = d_in ** -0.5
        return [(f"{name}.kernel", (d_in, d_out), -r, r), (f"{name}.bias", (d_out,), -r, r)]

    def net(name, blocks):
        specs = []
        r = (k * d) ** -0.5
        for b in range(blocks):
            for i in (1, 2):
                p = f"{name}.block{b}"
                specs += [(f"{p}.gn{i}.scale", (d,), 0.5, 1.5),
                          (f"{p}.gn{i}.bias", (d,), -0.5, 0.5),
                          (f"{p}.conv{i}.kernel", (k, d, d), -r, r),
                          (f"{p}.conv{i}.bias", (d,), -r, r)]
        return specs

    return (dense("input_proj", f, d) + net("f_movie", cfg["num_blocks"])
            + net("f_AR", cfg["ar_num_blocks"]) + dense("f_3D.fc1", d + out, h)
            + dense("f_3D.fc2", h, h) + dense("f_3D.fc3", h, out))


def trainable(cfg: dict) -> List[str]:
    """Phase 1's trained parameters: all but f_AR's."""
    return [n for n, *_ in param_specs(cfg) if not n.startswith("f_AR.")]


def group_norm_relu(x, scale, bias, groups: int, eps: float = 1e-5):
    b, t, d = x.shape
    xg = x.reshape(b, t, groups, d // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) / torch.sqrt(var + eps)).reshape(b, t, d)
    return torch.relu(xn * scale + bias)


def _mm(a, b, cast):
    return a @ b if cast is None else cast(a) @ cast(b)


def causal_conv(x, kernel, bias, cast=None):
    taps = kernel.shape[0]
    past = x[:, :1].expand(-1, taps - 1, -1)
    xp = torch.cat([past, x], dim=1)
    t = x.shape[1]
    out = bias
    for k in range(taps):
        out = out + _mm(xp[:, k:k + t], kernel[k], cast)
    return out


def forward(p: Params, feats, cfg: dict, mask: Optional[Callable] = None,
            cast: Optional[Callable] = None) -> torch.Tensor:
    """feats (B, T, F) -> joints (B, T, J, 3). `mask(shape)` draws a
    dropout mask (None: no dropout), once per f_movie block and then once
    per regressor round, in that order. `cast`, when given, rounds both
    operands of every matrix product (a lower precision's control)."""
    g = cfg["groups"]
    x = _mm(feats, p["input_proj.kernel"], cast) + p["input_proj.bias"]
    for b in range(cfg["num_blocks"]):
        q = f"f_movie.block{b}"
        m = mask(x.shape) if mask is not None else None
        h = causal_conv(group_norm_relu(x, p[f"{q}.gn1.scale"], p[f"{q}.gn1.bias"], g),
                        p[f"{q}.conv1.kernel"], p[f"{q}.conv1.bias"], cast)
        if m is not None:
            h = h * m
        x = x + causal_conv(group_norm_relu(h, p[f"{q}.gn2.scale"], p[f"{q}.gn2.bias"], g),
                            p[f"{q}.conv2.kernel"], p[f"{q}.conv2.bias"], cast)
    bsz, t, d = x.shape
    phi = x.reshape(bsz * t, d)
    out = 3 * cfg["joints_num"]
    y = torch.zeros((bsz * t, out), dtype=x.dtype, device=x.device)
    for _ in range(cfg["regressor_iters"]):
        hid = torch.relu(_mm(torch.cat([phi, y], dim=1), p["f_3D.fc1.kernel"], cast)
                         + p["f_3D.fc1.bias"])
        if mask is not None:
            hid = hid * mask(hid.shape)
        hid = torch.relu(_mm(hid, p["f_3D.fc2.kernel"], cast) + p["f_3D.fc2.bias"])
        y = y + _mm(hid, p["f_3D.fc3.kernel"], cast) + p["f_3D.fc3.bias"]
    return y.reshape(bsz, t, cfg["joints_num"], 3)


def loss_and_grads(p: Params, names: List[str], feats, joints3d, cfg: dict,
                   mask: Optional[Callable] = None):
    """(loss, {name: gradient}) of the mean squared joint error, by
    autograd through :func:`forward`."""
    leaves = {n: p[n].detach().clone().requires_grad_(True) for n in names}
    q = {**p, **leaves}
    joints = forward(q, feats, cfg, mask)
    loss = torch.mean((joints - joints3d) ** 2)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    return loss.detach(), dict(zip(names, grads))


class AdamW:
    """mu, nu, bias-corrected update, decoupled weight decay."""

    def __init__(self, params: Params, names: List[str], lr: float,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.p, self.names = params, names
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, weight_decay, b1, b2, eps
        self.mu = {n: torch.zeros_like(params[n]) for n in names}
        self.nu = {n: torch.zeros_like(params[n]) for n in names}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Params) -> None:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for n in self.names:
            g = grads[n]
            self.mu[n] = self.b1 * self.mu[n] + (1.0 - self.b1) * g
            self.nu[n] = self.b2 * self.nu[n] + (1.0 - self.b2) * g * g
            u = (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + self.eps)
            self.p[n] = self.p[n] - self.lr * (u + self.wd * self.p[n])
