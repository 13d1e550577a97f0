"""Train and eval steps on one device (counterpart of h36x/train/step.py).

A train step is forward + loss + backward + AdamW update + metrics, in
place on the model and the optimizer. Phase 1 (and 0): the loss is 3D MSE
(plus `lambda_2d` times the 2D reprojection MSE when that is above 0);
MPJPE and bone-length error are metrics. Phase 2
(:func:`make_future_train_step`): f_AR's one-step prediction loss plus
`lambda_joints` times the 3D MSE of the joints regressed from it, both over
the curriculum window.

`fused=True` runs the forward and backward of every residual block through
the hand-written kernels (B1/B2) and, at dropout 0, the regressor through
B3/B4 (:func:`h36x_torch.infer.phd_forward_train_fused`); `fused=False` is
plain autograd through the plain ops. On CPU tensors both are the plain
path. Phase 2 is plain, as in h36x. Eval steps of phase 1 skip f_AR, as the
fused forward does: joints do not read it.

Under a model compute dtype (`--model.dtype bfloat16`) the plain step and
every eval step compute in it, as h36x's `model.apply` does; the losses
come out float32 (phase 1's promoted by its float32 targets, phase 2's
taken in float32, as h36x's). `fused=True` runs the kernels in float32
whatever the dtype, as h36x's fused step does.

Grouped modes (:class:`TrainStep`): `scan_steps = k` makes k updates from a
stacked group (k, B, ...) of batches; on CUDA each full group is one replay
of a CUDA graph holding the k steps (forward, backward, AdamW), the
counterpart of h36x's one-dispatch `lax.scan`. `accum_steps = k` makes one
update from the mean gradient of k microbatches.

Data-parallel (a process group of several processes, each step given this
process's rows of the global batch): between backward and AdamW the
trainable gradients and the step's metrics are averaged over the processes
with one flat all-reduce, which is h36x's mean over the global batch, and
the dropout masks are the global batch's, this process's rows of them
(:func:`h36x_torch.infer.dropout_mask`). Grouped steps then run eagerly:
a gloo collective cannot sit in a CUDA graph.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from h36x_torch.infer import make_fused_forward
from h36x_torch.models.phd import param_tree
from h36x_torch.parallel.distributed import mean_across_processes, process_info
from h36x_torch.train.losses import (
    bone_length_loss,
    bone_length_per_row,
    bone_lengths,
    mpjpe,
    mpjpe_per_row,
    mse2d_reproj,
    mse3d,
    mse3d_per_row,
)


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


def _window(t_len: int, input_len: int, horizon, device):
    """The AR window [input_len, input_len + horizon) of a clip of t_len
    frames as a float32 (T,) mask, and its frame count (at least 1).
    `horizon` may be a 0-d device tensor (a captured step reads it there)."""
    if input_len >= t_len:
        # an empty window would mask the whole loss to exactly 0: zero
        # gradients, and a val "mpjpe" of 0.0 recorded as a perfect best
        raise ValueError(
            f"optim.input_len={input_len} >= clip length {t_len}: the "
            "phase-2 AR window is empty; lower --optim.input-len or "
            "extract longer clips")
    t_idx = torch.arange(t_len, device=device)
    mask = ((t_idx >= input_len) & (t_idx < input_len + horizon)).float()
    return mask, torch.clamp(mask.sum(), min=1.0)


def future_grads_and_metrics(model, batch, generator: Optional[torch.Generator],
                             horizon, *, input_len: int = 15,
                             lambda_joints: float = 1.0) -> dict:
    """Phase 2's forward + loss + backward of one batch (h36x's
    make_future_train_step loss): phi_hat, f_AR's one-step prediction of
    phi, against phi itself (detached, float32), plus lambda_joints times
    the 3D MSE of f_3D(phi_hat), both over the window [input_len, input_len
    + horizon); mpjpe over the same window. Returns {loss, l_ar, l3d,
    mpjpe} as 0-d tensors."""
    feats, joints3d = batch[0], batch[1]
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        phi, phi_hat, joints_hat = model(feats.float(), predict_future=True,
                                         train=True, use_kernels=False,
                                         dropout_generator=generator)
        mask, denom = _window(phi.shape[1], input_len, horizon, phi.device)
        # float32 even under a bfloat16 model: both operands are the net's
        # activations, and a bf16 difference would quantize the loss
        target = phi.detach().float()
        l_ar = torch.sum(torch.mean((phi_hat.float() - target) ** 2, dim=(0, 2))
                         * mask) / denom
        l3d = torch.sum(torch.mean((joints_hat - joints3d) ** 2, dim=(0, 2, 3))
                        * mask) / denom
        loss = l_ar + lambda_joints * l3d
    loss.backward()
    with torch.no_grad():
        err = torch.linalg.vector_norm(joints_hat.detach().float() - joints3d.float(),
                                       dim=-1)
        mp = torch.sum(torch.mean(err, dim=(0, 2)) * mask) / denom
    return {"loss": loss.detach(), "l_ar": l_ar.detach(), "l3d": l3d.detach(),
            "mpjpe": mp}


def _stack(metrics: list) -> dict:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


class TrainStep:
    """step(batch, generator) -> metrics: optimizer updates in place.

    `generator` draws the dropout masks (a torch.Generator on the model's
    device; may be None at dropout 0). A trainable parameter that the loss
    does not reach gets a zero gradient, so AdamW still applies its weight
    decay, as optax does.

    Ungrouped (`group` 1): one batch, one update, metrics 0-d. Grouped, the
    call takes a stacked group (k, B, ...), k at most `group` (an epoch's
    last group may be shorter), and returns each metric stacked (k,):

    - `scan_steps = k`: k updates, one per batch, as k ungrouped calls. On
      the CPU a Python loop. On CUDA the first full group of each batch
      shape runs eagerly on a side stream (building the kernels' state),
      then the group's k steps are captured as ONE CUDA graph over a static
      stacked input buffer; every later full group of that shape is one
      replay (`graph_replays`). The dropout generator is registered with the
      graph, so each replay draws new masks; the learning rate and AdamW's
      count are device tensors the graph reads. A shorter group runs
      eagerly through the same step function (same kernels, same bits). A
      capture that fails raises: it never falls back to eager steps.
    - `accum_steps = k`: the gradients of the k microbatches summed,
      divided by k, and ONE update. It runs eagerly on the card too: its
      purpose is memory (effective batch k * B at the memory of B), not
      dispatch count.

    `eager_steps` counts the updates run eagerly, `graph_replays` the
    replays (each `scan_steps` updates).

    In a process group of several processes (the module docstring) every
    update averages the gradients and metrics over the processes first,
    and groups run eagerly."""

    def __init__(self, model, optimizer, grads_fn: Callable, scan_steps: int = 1,
                 accum_steps: int = 1):
        if scan_steps > 1 and accum_steps > 1:
            raise ValueError("scan_steps and accum_steps are mutually exclusive")
        self.model = model
        self.optimizer = optimizer
        self.grads_fn = grads_fn
        self.scan_steps = max(1, scan_steps)
        self.accum_steps = max(1, accum_steps)
        self.group = max(self.scan_steps, self.accum_steps)
        self.trainable = [p for g in optimizer.param_groups for p in g["params"]]
        self.processes = process_info()[1]
        self.graph_replays = 0
        self.eager_steps = 0
        self._graphs: dict = {}

    def _update(self, batch, generator=None) -> dict:
        """One optimizer update from one batch, eagerly."""
        metrics = self.grads_fn(batch, generator)
        for p in self.trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        mean_across_processes([p.grad for p in self.trainable] + list(metrics.values()))
        self.optimizer.step()
        return metrics

    def __call__(self, batch, generator: Optional[torch.Generator] = None) -> dict:
        if self.group == 1:
            self.eager_steps += 1
            return self._update(batch, generator)
        if batch[0].shape[0] > self.group:
            raise ValueError(f"a group of {batch[0].shape[0]} batches; this step "
                             f"takes at most {self.group}")
        if self.accum_steps > 1:
            return self._accumulate(batch, generator)
        if (batch[0].device.type != "cuda" or batch[0].shape[0] < self.scan_steps
                or self.processes > 1):
            return self.run_eager(batch, generator)
        key = tuple((tuple(b.shape), b.dtype) for b in batch)
        if key not in self._graphs:
            # eager first, on a side stream as CUDA graph captures want: the
            # kernels' build and attributes, the libraries' handles and
            # workspaces exist before the capture records the steps
            cur = torch.cuda.current_stream(batch[0].device)
            side = torch.cuda.Stream(batch[0].device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = self.run_eager(batch, generator)
            cur.wait_stream(side)
            self._graphs[key] = self._capture(batch, generator)
            return out
        return self._replay(key, batch, generator)

    def run_eager(self, batches, generator=None) -> dict:
        """The group's updates one by one, eagerly; metrics stacked (k,)."""
        out = [self._update(tuple(b[i] for b in batches), generator)
               for i in range(batches[0].shape[0])]
        self.eager_steps += len(out)
        return _stack(out)

    def _accumulate(self, batches, generator) -> dict:
        n = batches[0].shape[0]
        acc = [torch.zeros_like(p) for p in self.trainable]
        out = []
        for i in range(n):
            out.append(self.grads_fn(tuple(b[i] for b in batches), generator))
            for a, p in zip(acc, self.trainable):
                if p.grad is not None:
                    a.add_(p.grad)
        for a, p in zip(acc, self.trainable):
            p.grad = a.div_(n)
        metrics = _stack(out)
        mean_across_processes(acc + list(metrics.values()))
        self.optimizer.step()
        self.eager_steps += 1
        return metrics

    def _capture(self, batches, generator):
        """Record the group's steps as one CUDA graph over static copies of
        `batches`. A capture runs nothing: params and state stay as they
        are."""
        static_in = [b.clone() for b in batches]
        graph = torch.cuda.CUDAGraph()
        if generator is not None and self.model.dropout > 0.0:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    f"torch {torch.__version__} cannot register a dropout "
                    "generator with a CUDA graph; run --optim.steps-per-dispatch "
                    "1 or --model.dropout 0")
            graph.register_generator_state(generator)
        self.model.zero_grad(set_to_none=True)
        # thread_local: the feed's thread goes on copying batches meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = _stack([self._update(tuple(s[i] for s in static_in), generator)
                          for i in range(self.scan_steps)])
        return graph, static_in, out, generator

    def _replay(self, key, batches, generator=None) -> dict:
        """One replay of the graph captured for `key` on `batches`; metrics
        cloned out of the graph's buffers (the next replay rewrites them)."""
        graph, static_in, out, captured_with = self._graphs[key]
        if generator is not captured_with:
            raise ValueError("the graphed step draws its dropout masks from the "
                             "generator it was captured with: reseed that one "
                             "(manual_seed) instead of passing another")
        for s, b in zip(static_in, batches):
            s.copy_(b)
        graph.replay()
        self.graph_replays += 1
        return {k: v.clone() for k, v in out.items()}


class FutureTrainStep(TrainStep):
    """Phase 2's :class:`TrainStep`: step(batch, generator, horizon). The
    horizon reaches the step through a 0-d int32 device tensor, filled in
    place on every call, so one captured graph serves every epoch."""

    def __init__(self, model, optimizer, input_len: int, lambda_joints: float,
                 scan_steps: int = 1, accum_steps: int = 1):
        dev = next(model.parameters()).device
        self.horizon = torch.zeros((), dtype=torch.int32, device=dev)

        def grads(batch, generator):
            return future_grads_and_metrics(model, batch, generator, self.horizon,
                                            input_len=input_len,
                                            lambda_joints=lambda_joints)

        super().__init__(model, optimizer, grads, scan_steps, accum_steps)

    def __call__(self, batch, generator=None, horizon=1) -> dict:
        if isinstance(horizon, torch.Tensor):
            self.horizon.copy_(horizon)
        else:
            self.horizon.fill_(int(horizon))
        return super().__call__(batch, generator)


def make_train_step(model, optimizer, fused: bool = False,
                    lambda_2d: float = 0.0, scan_steps: int = 1,
                    accum_steps: int = 1) -> TrainStep:
    """The phase-1 (and phase-0) :class:`TrainStep`:
    step(batch | group, generator) -> metrics {loss, l3d, l2d, mpjpe,
    bone}."""
    def grads(batch, generator):
        return grads_and_metrics(model, batch, generator, fused=fused,
                                 lambda_2d=lambda_2d)

    return TrainStep(model, optimizer, grads, scan_steps, accum_steps)


def make_future_train_step(model, optimizer, input_len: int = 15,
                           pred_len: int = 25, lambda_joints: float = 1.0,
                           scan_steps: int = 1,
                           accum_steps: int = 1) -> FutureTrainStep:
    """Phase 2's step (h36x/train/step.py::make_future_train_step): train
    f_AR, the other modules frozen by the phase-2 optimizer.

      loss = mse(phi_hat, detach(phi))         over the curriculum window
           + lambda_joints * mse(joints_hat, gt) over the curriculum window

    step(batch | group, generator, horizon) -> metrics {loss, l_ar, l3d,
    mpjpe}; the window is [input_len, input_len + horizon), horizon per call
    (:func:`curriculum_horizon` of the epoch). `pred_len` bounds the horizon
    in the caller's curriculum; it is taken here for h36x's signature.
    Plain ops (h36x has no fused phase-2 step)."""
    del pred_len
    return FutureTrainStep(model, optimizer, input_len, lambda_joints,
                           scan_steps, accum_steps)


def curriculum_horizon(epoch: int, pred_len: int = 25, steps: int = 25) -> int:
    """AR supervision horizon of an epoch: 1 -> pred_len over `steps`
    epochs."""
    if steps <= 0:
        return pred_len
    return min(pred_len, 1 + epoch * pred_len // steps)


def make_forward(model, use_kernels: bool = True) -> Callable:
    """forward(feats) -> joints_pred (B,T,J,3), eval mode, f_AR skipped, at
    precise=True: the trainer's eval and the results stage keep float32.
    A model with a compute dtype runs the plain engine in it (h36x's eval is
    `model.apply` at the model's dtype), whatever `use_kernels` says; a
    tensor-parallel one its slices' plain forward."""
    if model.tp is not None:
        from h36x_torch.parallel import tensor
        return lambda feats: tensor.joints(model, feats.float())
    use_kernels = use_kernels and model.dtype is None

    def forward(feats):
        fwd = make_fused_forward(param_tree(model), joints_num=model.joints_num,
                                 groups=model.groups, use_kernels=use_kernels,
                                 regressor_iters=model.regressor_iters, precise=True,
                                 dtype=model.dtype)
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


def make_weighted_future_eval_step(model, input_len: int = 15, pred_len: int = 25,
                                   lambda_joints: float = 1.0,
                                   use_kernels: bool = False) -> Callable:
    """Phase 2's validation step (h36x's make_weighted_future_eval_step):
    scores the AR path, which phase 2 trains, over the full prediction
    window [input_len, input_len + pred_len) (no curriculum), with the
    weighted-SUM contract of :func:`make_weighted_eval_step`: loss = l_ar +
    lambda_joints * l3d, mpjpe and bone on the AR-predicted joints, each a
    per-row window mean weighted by the row's weight. `use_kernels=False`,
    as h36x scores phase 2 on its plain path."""

    def step(batch):
        joints3d, w = batch[1], batch[-1]
        phi, phi_hat, _, joints_hat = model(batch[0].float(), predict_future=True,
                                            use_kernels=use_kernels)
        mask, denom = _window(phi.shape[1], input_len, pred_len, phi.device)

        def window_mean(per_frame):  # (B, T) -> (B,)
            return torch.sum(per_frame * mask, dim=1) / denom

        jh, j3 = joints_hat.float(), joints3d.float()
        l_ar = window_mean(torch.mean((phi_hat.float() - phi.float()) ** 2, dim=2))
        l3d = window_mean(torch.mean((jh - j3) ** 2, dim=(2, 3)))
        mp = window_mean(torch.mean(torch.linalg.vector_norm(jh - j3, dim=-1), dim=2))
        bone = window_mean(torch.mean((bone_lengths(jh) - bone_lengths(j3)) ** 2, dim=2))
        return {"loss": torch.dot(w, l_ar + lambda_joints * l3d),
                "l3d": torch.dot(w, l3d), "mpjpe": torch.dot(w, mp),
                "bone": torch.dot(w, bone), "n": torch.sum(w)}

    return step
