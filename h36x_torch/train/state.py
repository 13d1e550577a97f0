"""Optimizer construction and the learning-rate schedule (counterpart of
h36x/train/state.py).

AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on every
trainable parameter, as optax's unmasked `adamw`, in optax's float32
arithmetic), a cosine learning rate stepped once per epoch, and per-phase
module freezing: a frozen module's parameters get no gradient
(`requires_grad` off), no update and no Adam state, as with optax's
`set_to_zero` branch. The state sits on the device, where a CUDA graph of
the train step can replay it (:class:`AdamW`).
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
HYPER = ("lr", "b1", "b2", "eps", "weight_decay")  # AdamW's hyper-parameters


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
    skipped.

    The state lives on the params' device, so that a CUDA graph of the
    step replays it: `count` (int32, one for the optimizer, as optax keeps
    it), the hyper-parameters `hyper` (float32 0-d tensors; the learning
    rate changes in place, :func:`set_learning_rate`), and per trainable
    parameter "mu" and "nu", made at construction. The eager step and a
    replayed one run the same operations, so they give the same bits."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-2):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        if len(self.param_groups) != 1:
            raise ValueError("AdamW takes one parameter group")
        group = self.param_groups[0]
        dev = group["params"][0].device
        self.hyper = {k: torch.tensor(group[k], dtype=torch.float32, device=dev)
                      for k in HYPER}
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        for p in group["params"]:
            self.state[p]["mu"] = torch.zeros_like(p)
            self.state[p]["nu"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        h = self.hyper
        b1, b2, eps, wd = h["b1"], h["b2"], h["eps"], h["weight_decay"]
        neg_lr = -h["lr"]
        self.count.add_(1)
        count = self.count.float()
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        c1, c2 = 1 - b1, 1 - b2
        for p in self.param_groups[0]["params"]:
            if p.grad is None:
                continue
            g = p.grad
            st = self.state[p]
            mu, nu = st["mu"], st["nu"]
            mu.mul_(b1).add_(g * c1)
            nu.mul_(b2).add_(g * g * c2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
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
    """Set the learning rate of every parameter group, in place: for
    :class:`AdamW` also its device scalar, which a captured step reads."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    if isinstance(optimizer, AdamW):
        optimizer.hyper["lr"].fill_(lr)


def optimizer_tensors(optimizer: AdamW) -> list:
    """Every tensor of an :class:`AdamW`'s state, in a fixed order: count,
    the hyper-parameters, then mu and nu of each trainable parameter (to
    snapshot and restore it in place)."""
    out = [optimizer.count, *(optimizer.hyper[k] for k in HYPER)]
    for p in optimizer.param_groups[0]["params"]:
        out += [optimizer.state[p]["mu"], optimizer.state[p]["nu"]]
    return out
