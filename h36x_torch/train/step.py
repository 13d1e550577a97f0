"""Train and eval steps on one device (counterpart of h36x/train/step.py).

A train step is forward + loss + backward + AdamW update + metrics, in
place on the model and the optimizer. The loss is 3D MSE (plus
`lambda_2d` times the 2D reprojection MSE when that is above 0); MPJPE and
bone-length error are metrics.

`fused=True` runs the forward and backward of every residual block through
the hand-written kernels (B1/B2) and, at dropout 0, the regressor through
B3/B4 (:func:`h36x_torch.infer.phd_forward_train_fused`); `fused=False` is
plain autograd through the plain ops. On CPU tensors both are the plain
path. Eval steps skip f_AR, as the fused forward does: joints do not read
it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from h36x_torch.infer import make_fused_forward
from h36x_torch.models.phd import param_tree
from h36x_torch.train.losses import (
    bone_length_loss,
    bone_length_per_row,
    mpjpe,
    mpjpe_per_row,
    mse2d_reproj,
    mse3d,
    mse3d_per_row,
)

_LATER = ("{} > 1 is not ported to h36x_torch yet (it comes with a later "
          "slice); train with the default of 1")


def grads_and_metrics(model, batch, generator: Optional[torch.Generator] = None,
                      *, fused: bool = False, lambda_2d: float = 0.0) -> dict:
    """Forward + loss + backward of one batch: the parameters' `.grad` hold
    the gradients afterwards (set anew, not accumulated). batch = (feats
    (B,T,F), joints3d (B,T,J,3), joints2d (B,T,J,2), K (B,3,3), ...).
    Returns the step's metrics as 0-d tensors on the device."""
    feats, joints3d, joints2d, K = batch[0], batch[1], batch[2], batch[3]
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        _, joints_pred = model(feats.float(), train=True, use_kernels=fused,
                               dropout_generator=generator)
        l3d = mse3d(joints_pred, joints3d)
        if lambda_2d > 0.0:
            l2d = mse2d_reproj(joints_pred, joints2d, K)
            loss = l3d + lambda_2d * l2d
        else:
            l2d = torch.zeros_like(l3d)
            loss = l3d
    loss.backward()
    with torch.no_grad():
        pred = joints_pred.detach()
        return {"loss": loss.detach(), "l3d": l3d.detach(), "l2d": l2d.detach(),
                "mpjpe": mpjpe(pred, joints3d),
                "bone": bone_length_loss(pred, joints3d)}


def make_train_step(model, optimizer, fused: bool = False,
                    lambda_2d: float = 0.0, scan_steps: int = 1,
                    accum_steps: int = 1) -> Callable:
    """step(batch, generator) -> metrics: one optimizer update in place.

    `generator` draws the dropout masks (a torch.Generator on the model's
    device; may be None at dropout 0). A trainable parameter that the loss
    does not reach gets a zero gradient, so AdamW still applies its weight
    decay, as optax does."""
    if scan_steps > 1:
        raise NotImplementedError(_LATER.format("--optim.steps-per-dispatch"))
    if accum_steps > 1:
        raise NotImplementedError(_LATER.format("--optim.grad-accum"))
    trainable = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch, generator: Optional[torch.Generator] = None) -> dict:
        metrics = grads_and_metrics(model, batch, generator, fused=fused,
                                    lambda_2d=lambda_2d)
        for p in trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return metrics

    return step


def make_forward(model, use_kernels: bool = True) -> Callable:
    """forward(feats) -> joints_pred (B,T,J,3), eval mode, f_AR skipped, at
    precise=True: the trainer's eval and the results stage keep float32."""
    def forward(feats):
        fwd = make_fused_forward(param_tree(model), joints_num=model.joints_num,
                                 groups=model.groups, use_kernels=use_kernels,
                                 regressor_iters=model.regressor_iters, precise=True)
        return fwd(feats.float())

    return forward


def make_eval_step(model, return_preds: bool = False,
                   use_kernels: bool = True) -> Callable:
    """step(batch) -> metrics (and the predictions with `return_preds`)."""
    forward = make_forward(model, use_kernels)

    def step(batch):
        joints3d = batch[1]
        pred = forward(batch[0])
        l3d = mse3d(pred, joints3d)
        metrics = {"loss": l3d, "l3d": l3d, "mpjpe": mpjpe(pred, joints3d),
                   "bone": bone_length_loss(pred, joints3d)}
        return (metrics, pred) if return_preds else metrics

    return step


def make_weighted_eval_step(model, use_kernels: bool = True) -> Callable:
    """Eval step returning weighted per-batch SUMS instead of means:
    batch = (feats, joints3d, ..., weights), weights float32 (B,) with 0 on
    padded rows, so the caller forms exact dataset means."""
    forward = make_forward(model, use_kernels)

    def step(batch):
        joints3d, w = batch[1], batch[-1]
        pred = forward(batch[0])
        l3d = torch.dot(w, mse3d_per_row(pred, joints3d))
        return {"loss": l3d, "l3d": l3d,
                "mpjpe": torch.dot(w, mpjpe_per_row(pred, joints3d)),
                "bone": torch.dot(w, bone_length_per_row(pred, joints3d)),
                "n": torch.sum(w)}

    return step
