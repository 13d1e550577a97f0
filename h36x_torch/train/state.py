"""Optimizer construction and the learning-rate schedule (counterpart of
h36x/train/state.py).

AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on every
trainable parameter, as optax's unmasked `adamw`, in optax's float32
arithmetic), a cosine learning rate stepped once per epoch, and per-phase
module freezing: a frozen module's parameters get no gradient
(`requires_grad` off), no update and no Adam state, as with optax's
`set_to_zero` branch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# top-level modules frozen in each training phase (h36x/train/state.py)
PHASE_FROZEN = {
    1: ("f_AR",),
    2: ("f_movie", "f_3D", "input_proj"),
    0: (),  # train everything
}


def cosine_lr(epoch: int, base_lr: float, total_epochs: int, min_lr: float = 0.0) -> float:
    """Per-epoch cosine annealing: lr(e) = min + (base-min)(1+cos(pi e/T))/2."""
    t = min(epoch, total_epochs)
    return min_lr + (base_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * t / total_epochs))


class AdamW(torch.optim.Optimizer):
    """optax.adamw's update, operation for operation in float32:

        mu = (1-b1) g + b1 mu;  nu = (1-b2) g^2 + b2 nu;  count += 1
        u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
        p += -lr * (u + weight_decay * p)

    Every hyper-parameter is a float32 scalar, as `optax.inject_hyperparams`
    makes them (so 1 - b1 is 1 - float32(0.9), not 0.1), and the bias
    corrections are float32 `pow`s, as XLA computes them: `1 - b2^count`
    cancels, and torch.optim.AdamW's float64 corrections differ from
    optax's by up to 1e-5 relative. A parameter without a gradient is
    skipped. State per parameter: "count", "mu", "nu"."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-2):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")

        def f32(v):
            return torch.tensor(v, dtype=torch.float32)

        for group in self.param_groups:
            b1, b2, eps = f32(group["b1"]), f32(group["b2"]), f32(group["eps"])
            wd, neg_lr = f32(group["weight_decay"]), -f32(group["lr"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                mu, nu = st["mu"], st["nu"]
                mu.mul_(b1).add_(g * (1 - b1))
                nu.mul_(b2).add_(g * g * (1 - b2))
                st["count"] += 1
                count = f32(float(st["count"]))
                u = (mu / (1 - b1 ** count)) / (torch.sqrt(nu / (1 - b2 ** count)) + eps)
                p.add_((u + wd * p) * neg_lr)
        return None


def frozen_names(names, frozen_prefixes) -> set:
    """The parameter names (dotted, as in a state_dict) under the top-level
    modules `frozen_prefixes`. A prefix that names no module raises: it
    would silently train the weights it was meant to freeze."""
    modules = {n.split(".", 1)[0] for n in names}
    missing = set(frozen_prefixes) - modules
    if missing:
        raise ValueError(
            f"frozen module(s) {sorted(missing)} not found in params "
            f"(top-level modules: {sorted(modules)})")
    return {n for n in names if n.split(".", 1)[0] in frozen_prefixes}


def make_optimizer(model: torch.nn.Module, lr: float, weight_decay: float = 1e-2,
                   freeze_ar: bool = True, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, phase: Optional[int] = None):
    """AdamW over the model's trainable parameters, freezing the rest.

    `phase` overrides `freeze_ar` when given. Returns (optimizer, frozen
    module names)."""
    if phase is None:
        frozen = ("f_AR",) if freeze_ar else ()
    else:
        frozen = PHASE_FROZEN[phase]
    named = dict(model.named_parameters())
    skip = frozen_names(named, frozen)
    for name, p in named.items():
        p.requires_grad_(name not in skip)
    trainable = [p for name, p in named.items() if name not in skip]
    opt = AdamW(trainable, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return opt, frozen


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group, in place."""
    for group in optimizer.param_groups:
        group["lr"] = lr
