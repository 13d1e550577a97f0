"""Serving: streaming per-frame inference and autoregressive future rollout
(counterpart of h36x/serve.py).

The PHD architecture is built to *predict* 3D dynamics: f_AR forecasts the
next movie strip, f_3D decodes strips to joints. On top of the param-tree
engines in :mod:`h36x_torch.infer`:

- :func:`make_rollout_fn` — multi-step AR rollout: given a T-frame feature
  window, extend the movie-strip sequence `steps` frames into the future
  and decode the future joints. The causal convs never look right and
  GroupNorm, the block's one non-causal op, takes its statistics over the
  frames that exist, so step s is exactly f_AR over the first T + s strips.
  The plain path runs that as h36x does, over a fixed (B, T + steps, D)
  buffer with statistics masked to [0, T + s); with the kernels on, on CUDA
  tensors, f_AR runs over the prefix `buf[:, :T + s]` through the fused
  residual block (eager PyTorch pays nothing for a changing T), which is
  the same function.
- :class:`StreamingPredictor` — per-frame online inference over a sliding
  feature window (ring buffer warm-started by edge replication, matching
  the causal convs' left edge padding), with optional future rollout.

Everything runs under `torch.inference_mode()` on an explicit device (cuda
unless the caller asks for another).
"""

from __future__ import annotations

import numpy as np
import torch

from h36x_torch.infer import (
    _regressor,
    _temporal_net,
    _temporal_net_masked,
    sorted_blocks,
)
from h36x_torch.ops.causal_conv import causal_conv1d
from h36x_torch.utils.runtime import resolve_device


def _project(params, feats):
    return feats @ params["input_proj"]["kernel"] + params["input_proj"]["bias"]


@torch.inference_mode()
def _rollout_from_x(params, x, steps: int, joints_num: int, groups: int,
                    use_kernels: bool, with_ctx: bool = True,
                    regressor_iters: int = 3):
    """Rollout over already-projected inputs x (B, T, latent) -> (joints_ctx,
    joints_future, phi_ext). The streaming predictor keeps its ring buffer
    in projected space, so it feeds this entry directly; with_ctx=False
    skips the context-window regressor pass for callers that only want the
    future frames (StreamingPredictor.forecast)."""
    phi = _temporal_net(x, params["f_movie"], groups, use_kernels)
    b, t, d = phi.shape
    buf = phi.new_zeros((b, t + steps, d))
    buf[:, :t] = phi
    # a CPU tensor takes the plain path, any other device the kernel's
    # wrapper (which launches on cuda and raises elsewhere)
    fused = use_kernels and phi.device.type != "cpu"
    for s in range(steps):
        if fused:
            # f_AR over the strips that exist: rows of a longer buffer, so
            # the batch stride is (T + steps) * D (the wrapper takes that)
            ar = _temporal_net(buf[:, :t + s], params["f_AR"], groups, True)
        else:
            # fixed-shape buffer, GroupNorm statistics masked to the t + s
            # frames that exist; the causal convs guarantee that position
            # t + s - 1 only sees the already-written prefix
            ar = _temporal_net_masked(buf, params["f_AR"], groups,
                                      valid_len=t + s)
        buf[:, t + s] = ar[:, t + s - 1]

    joints_ctx = (_regressor(phi, params["f_3D"], joints_num, use_kernels,
                             iters=regressor_iters) if with_ctx else None)
    joints_future = _regressor(buf[:, t:], params["f_3D"], joints_num,
                               use_kernels, iters=regressor_iters)
    return joints_ctx, joints_future, buf


def _rollout(params, feats, steps: int, joints_num: int, groups: int,
             use_kernels: bool, regressor_iters: int = 3):
    """(params, feats (B, T, D_feat)) -> (joints_ctx (B, T, J, 3),
    joints_future (B, steps, J, 3), phi_ext (B, T + steps, D))."""
    with torch.inference_mode():
        x = _project(params, feats)
    return _rollout_from_x(params, x, steps, joints_num, groups, use_kernels,
                           True, regressor_iters)


def make_rollout_fn(steps: int, joints_num: int = 17, groups: int = 32,
                    use_kernels: bool = True, regressor_iters: int = 3,
                    device=None):
    """(params, feats (B, T, feature_dim)) ->
    (joints_ctx (B, T, J, 3), joints_future (B, steps, J, 3)), tensors on
    `device` (cuda unless the caller asks for another), where `params` (a
    flax-layout tree of tensors) must live. feats may be a numpy array.

    regressor_iters must match the checkpoint's training config."""
    device = resolve_device(device)

    def fn(params, feats):
        feats = torch.as_tensor(feats, dtype=torch.float32).to(device)
        ctx, fut, _ = _rollout(params, feats, steps, joints_num, groups,
                               use_kernels, regressor_iters)
        return ctx, fut

    return fn


# ---------------------------------------------------------------------------
# Streaming: per-frame inference
# ---------------------------------------------------------------------------
#
# GroupNorm in the residual blocks normalizes over (time, group-channels), so
# the window STATISTICS change every time the window slides: an exactly-
# equivalent push must rerun the temporal net over the window — O(window)
# work is inherent to the model's semantics, not an implementation choice.
# Two levers remain, both used here:
#
#   exact path    — the ring buffer lives in projected (latent) space so
#                   input_proj runs once per frame, and the joint regressor
#                   decodes ONLY the newest frame. Identical to a full
#                   forward.
#   frozen path   — freeze() captures each GroupNorm's window statistics and
#                   each causal conv's K-1 tap history; push then costs O(1)
#                   frames of compute regardless of window size. Outputs are
#                   exact w.r.t. the frozen-stats model (tested), and track
#                   the sliding-stats model as closely as the statistics are
#                   stationary — the right trade for long steady-state
#                   streams; call freeze() again (or unfreeze()) after a
#                   scene change.


def _gn_group_stats(x: torch.Tensor, groups: int, eps: float):
    """x (1, T, D) -> per-group (mean (G,), rstd (G,)) over (T, D/G)."""
    _, t_len, d = x.shape
    xg = x.reshape(t_len, groups, d // groups)
    mean = xg.mean(dim=(0, 2))
    var = ((xg - mean[None, :, None]) ** 2).mean(dim=(0, 2))
    return mean, torch.rsqrt(var + eps)


def _frozen_gn_relu(u, mean_g, rstd_g, scale, bias, groups: int):
    """Per-frame GN+ReLU with externally-fixed per-group statistics.
    u (..., D); mean_g/rstd_g (G,)."""
    rep = u.shape[-1] // groups
    mean = mean_g.repeat_interleave(rep)
    rstd = rstd_g.repeat_interleave(rep)
    return torch.relu((u - mean) * rstd * scale + bias)


def _capture_freeze(x, net_params, groups: int, eps: float):
    """Run the temporal net over the full window (1, T, D), returning
    (phi, per-block GN stats, per-block conv tap history). The tap history
    holds the last K-1 frames of each conv's input stream — exactly the
    state an O(1) streaming step needs."""
    stats, state = {}, {}
    for name in sorted_blocks(net_params):
        p = net_params[name]
        k_taps = p["conv1"]["kernel"].shape[0]
        mu1, rstd1 = _gn_group_stats(x, groups, eps)
        h = _frozen_gn_relu(x, mu1, rstd1, p["gn1"]["scale"], p["gn1"]["bias"],
                            groups)
        c1 = causal_conv1d(h, p["conv1"]["kernel"], p["conv1"]["bias"])
        mu2, rstd2 = _gn_group_stats(c1, groups, eps)
        g = _frozen_gn_relu(c1, mu2, rstd2, p["gn2"]["scale"],
                            p["gn2"]["bias"], groups)
        c2 = causal_conv1d(g, p["conv2"]["kernel"], p["conv2"]["bias"])
        stats[name] = {"mu1": mu1, "rstd1": rstd1, "mu2": mu2, "rstd2": rstd2}
        # history = last K-1 frames; spelled via a positive start index
        # because -(k_taps - 1) is -0 == "the whole window" when K == 1
        start = h.shape[1] - (k_taps - 1)
        state[name] = {"h": h[0, start:], "g": g[0, start:]}
        x = c2 + x
    return x, stats, state


def _stream_block(u, p, st, fs, groups: int):
    """One residual block on ONE new frame u (1, D) with frozen GN stats fs
    and conv tap history st; returns (out (1, D), new history)."""
    h = _frozen_gn_relu(u, fs["mu1"], fs["rstd1"], p["gn1"]["scale"],
                        p["gn1"]["bias"], groups)
    h_hist = torch.cat([st["h"], h], dim=0)  # (K, D)
    c1 = torch.einsum("kd,kdo->o", h_hist, p["conv1"]["kernel"])[None, :] \
        + p["conv1"]["bias"]
    g = _frozen_gn_relu(c1, fs["mu2"], fs["rstd2"], p["gn2"]["scale"],
                        p["gn2"]["bias"], groups)
    g_hist = torch.cat([st["g"], g], dim=0)
    c2 = torch.einsum("kd,kdo->o", g_hist, p["conv2"]["kernel"])[None, :] \
        + p["conv2"]["bias"]
    return c2 + u, {"h": h_hist[1:], "g": g_hist[1:]}


def _tree_to(tree, device):
    """A nested dict of tensors or arrays -> the same tree of tensors on
    `device` (no copy for a tensor that is there already)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).detach().to(device)


class StreamingPredictor:
    """Online per-frame 3D pose over a sliding feature window.

    push(feat) accepts one frame's backbone features (feature_dim,) and
    returns the newest frame's joints (J, 3) as numpy, one host
    synchronisation per push. Until `window` frames have arrived the buffer
    is left-filled with the first frame (the same edge semantics the causal
    convs use for t<0). `forecast(steps)` rolls the AR predictor `steps`
    frames past the current window.

    The ring buffer is kept in projected (latent) space on the device and
    only the newest frame is decoded, so a push reruns just the temporal
    net over the window (required for exact sliding-GroupNorm semantics —
    see module comment). freeze() switches to O(1)-per-push incremental
    inference with the GroupNorm statistics pinned at the freeze-time
    window: per-frame GN and a (K, D) x (K, D, O) contraction in plain
    PyTorch, then the regressor.

    `params` is a flax-layout tree of tensors (or arrays); it is moved to
    `device` (cuda unless the caller asks for another). With `use_kernels`
    the temporal net and the regressor run through the hand-written kernels
    on a CUDA device (and through their plain versions on the CPU).
    """

    def __init__(self, params, window: int = 40, feature_dim: int = 2048,
                 joints_num: int = 17, groups: int = 32,
                 use_kernels: bool = True, eps: float = 1e-5,
                 regressor_iters: int = 3, device=None):
        self.device = resolve_device(device)
        self.params = _tree_to(params, self.device)
        self.window = window
        self.feature_dim = int(self.params["input_proj"]["kernel"].shape[0])
        if feature_dim != self.feature_dim:
            raise ValueError(
                f"feature_dim={feature_dim} does not match the checkpoint's "
                f"input projection ({self.feature_dim})")
        self.joints_num = joints_num
        self.groups = groups
        self.use_kernels = use_kernels
        self.eps = eps
        self.regressor_iters = regressor_iters
        self._xbuf = None  # (1, window, latent) projected, device-resident
        self._seen = 0
        self._frozen = None  # (stats, state) trees when frozen

    @torch.inference_mode()
    def push(self, feat: np.ndarray) -> np.ndarray:
        """Add one frame's features; returns that frame's joints (J, 3)."""
        feat = np.asarray(feat, dtype=np.float32).reshape(-1)
        if feat.size != self.feature_dim:
            raise ValueError(
                f"feat has {feat.size} features, expected {self.feature_dim}")
        xnew = _project(self.params, torch.from_numpy(feat).to(self.device))
        if self._seen == 0:
            # edge-replicate warm start (constant window, so the roll below
            # is a no-op on content)
            self._xbuf = xnew[None, None, :].repeat(1, self.window, 1)
        self._seen += 1
        self._xbuf = torch.cat([self._xbuf[:, 1:], xnew[None, None, :]], dim=1)
        if self._frozen is not None:
            stats, state = self._frozen
            u = xnew[None, :]
            new_state = {}
            for name in sorted_blocks(self.params["f_movie"]):
                u, new_state[name] = _stream_block(
                    u, self.params["f_movie"][name], state[name], stats[name],
                    self.groups)
            self._frozen = (stats, new_state)
            phi_new = u[:, None, :]
        else:
            phi = _temporal_net(self._xbuf, self.params["f_movie"],
                                self.groups, self.use_kernels)
            phi_new = phi[:, -1:]
        joints = _regressor(phi_new, self.params["f_3D"], self.joints_num,
                            self.use_kernels, iters=self.regressor_iters)
        return joints[0, -1].cpu().numpy()

    @torch.inference_mode()
    def freeze(self) -> None:
        """Pin GroupNorm statistics at the current window and switch push()
        to O(1) incremental compute. Requires at least one pushed frame;
        call again later to re-pin the statistics to a newer window."""
        if self._seen == 0:
            raise RuntimeError("no frames pushed yet")
        _, stats, state = _capture_freeze(self._xbuf, self.params["f_movie"],
                                          self.groups, self.eps)
        self._frozen = (stats, state)

    def unfreeze(self) -> None:
        """Return to exact sliding-statistics inference."""
        self._frozen = None

    @property
    def frozen(self) -> bool:
        return self._frozen is not None

    def forecast(self, steps: int) -> np.ndarray:
        """AR rollout `steps` frames past the current window -> (steps, J, 3)."""
        if self._seen == 0:
            raise RuntimeError("no frames pushed yet")
        # with_ctx=False skips the context-window regressor pass (only the
        # future frames are wanted)
        _, future, _ = _rollout_from_x(
            self.params, self._xbuf, steps, self.joints_num, self.groups,
            self.use_kernels, False, self.regressor_iters)
        return future[0].cpu().numpy()

    @property
    def warm(self) -> bool:
        return self._seen >= self.window
