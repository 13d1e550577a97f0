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
unless the caller asks for another). Both engines default to
`precise=False` (bfloat16 weights, activations as bfloat16 pairs, float32
sums, about 1e-3 relative: :mod:`h36x_torch.infer`), with the bfloat16
weight copies made once where they take the params
(:func:`h36x_torch.infer.serving_params`); `precise=True` runs in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from h36x_torch.infer import (
    _regressor,
    _temporal_net,
    _temporal_net_masked,
    serving_params,
    sorted_blocks,
)
from h36x_torch.ops.causal_conv import causal_conv1d
from h36x_torch.utils.runtime import resolve_device


def _project(params, feats):
    return feats @ params["input_proj"]["kernel"] + params["input_proj"]["bias"]


@torch.inference_mode()
def _rollout_from_x(params, x, steps: int, joints_num: int, groups: int,
                    use_kernels: bool, with_ctx: bool = True,
                    regressor_iters: int = 3, precise: bool = True):
    """Rollout over already-projected inputs x (B, T, latent) -> (joints_ctx,
    joints_future, phi_ext). The streaming predictor keeps its ring buffer
    in projected space, so it feeds this entry directly; with_ctx=False
    skips the context-window regressor pass for callers that only want the
    future frames (StreamingPredictor.forecast). `precise` as in the
    engine; params may be its :func:`h36x_torch.infer.serving_params`."""
    phi = _temporal_net(x, params["f_movie"], groups, use_kernels, precise)
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
            ar = _temporal_net(buf[:, :t + s], params["f_AR"], groups, True,
                               precise)
        else:
            # fixed-shape buffer, GroupNorm statistics masked to the t + s
            # frames that exist; the causal convs guarantee that position
            # t + s - 1 only sees the already-written prefix
            ar = _temporal_net_masked(buf, params["f_AR"], groups,
                                      valid_len=t + s, precise=precise)
        buf[:, t + s] = ar[:, t + s - 1]

    joints_ctx = (_regressor(phi, params["f_3D"], joints_num, use_kernels,
                             regressor_iters, precise) if with_ctx else None)
    joints_future = _regressor(buf[:, t:], params["f_3D"], joints_num,
                               use_kernels, regressor_iters, precise)
    return joints_ctx, joints_future, buf


def _rollout(params, feats, steps: int, joints_num: int, groups: int,
             use_kernels: bool, regressor_iters: int = 3, precise: bool = True):
    """(params, feats (B, T, D_feat)) -> (joints_ctx (B, T, J, 3),
    joints_future (B, steps, J, 3), phi_ext (B, T + steps, D))."""
    with torch.inference_mode():
        x = _project(params, feats)
    return _rollout_from_x(params, x, steps, joints_num, groups, use_kernels,
                           True, regressor_iters, precise)


def make_rollout_fn(params, steps: int, joints_num: int = 17, groups: int = 32,
                    use_kernels: bool = True, regressor_iters: int = 3,
                    device=None, precise: bool = False):
    """feats (B, T, feature_dim) -> (joints_ctx (B, T, J, 3), joints_future
    (B, steps, J, 3)), tensors on `device` (cuda unless the caller asks for
    another), over `params` (a flax-layout tree of tensors or arrays), which
    are moved there and whose fast-mode copies
    (:func:`h36x_torch.infer.serving_params`) are made here, once. feats
    may be a numpy array.

    regressor_iters must match the checkpoint's training config."""
    device = resolve_device(device)
    params = serving_params(_tree_to(params, device), use_kernels, precise)

    def fn(feats):
        feats = torch.as_tensor(feats, dtype=torch.float32).to(device)
        ctx, fut, _ = _rollout(params, feats, steps, joints_num, groups,
                               use_kernels, regressor_iters, precise)
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


def _stream_block(u, p, st, fs):
    """One residual block on ONE new frame u (1, D) with GroupNorm statistics
    fs frozen per channel ({mean1, rstd1, mean2, rstd2}, each (D,)) and conv
    tap history st ({h, g}, each (K-1, D)), which it updates in place;
    returns out (1, D). The arithmetic of h36x's frozen block."""
    h = torch.relu((u - fs["mean1"]) * fs["rstd1"] * p["gn1"]["scale"]
                   + p["gn1"]["bias"])
    h_hist = torch.cat([st["h"], h], dim=0)  # (K, D)
    c1 = torch.einsum("kd,kdo->o", h_hist, p["conv1"]["kernel"])[None, :] \
        + p["conv1"]["bias"]
    g = torch.relu((c1 - fs["mean2"]) * fs["rstd2"] * p["gn2"]["scale"]
                   + p["gn2"]["bias"])
    g_hist = torch.cat([st["g"], g], dim=0)
    c2 = torch.einsum("kd,kdo->o", g_hist, p["conv2"]["kernel"])[None, :] \
        + p["conv2"]["bias"]
    st["h"].copy_(h_hist[1:])
    st["g"].copy_(g_hist[1:])
    return c2 + u


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
    PyTorch (float32, as h36x's frozen block), then the regressor.

    The frozen push is one step over static buffers that live as long as the
    freeze (the features in, the window, each block's tap histories, the
    per-channel frozen statistics, the joints out), updated in place. On a
    CUDA device the first frozen push after freeze() runs the step eagerly
    (the kernels built, their one-time set-up done) and then captures it, from
    the projection to the joints, as one CUDA graph; every later push copies
    the features in, replays the graph and reads the joints back, and adds
    one to `replays`: the graph's launches run without the kernels'
    wrappers, which count only the eager push and none at the capture.
    freeze() again, or unfreeze(), throws the graph away. On the CPU the
    same step runs eagerly.

    `params` is a flax-layout tree of tensors (or arrays); it is moved to
    `device` (cuda unless the caller asks for another). With `use_kernels`
    the temporal net and the regressor run through the hand-written kernels
    on a CUDA device (and through their plain versions on the CPU), at
    `precise` (False by default, with the bfloat16 weight copies made here,
    once: :func:`h36x_torch.infer.serving_params`).
    """

    def __init__(self, params, window: int = 40, feature_dim: int = 2048,
                 joints_num: int = 17, groups: int = 32,
                 use_kernels: bool = True, eps: float = 1e-5,
                 regressor_iters: int = 3, device=None, precise: bool = False):
        self.device = resolve_device(device)
        self.params = serving_params(_tree_to(params, self.device), use_kernels,
                                     precise)
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
        self.precise = precise
        self._xbuf = None  # (1, window, latent) projected, device-resident
        self._seen = 0
        self._frozen = None  # (stats, state) trees when frozen
        self._io = None  # the frozen step's input and output buffers
        self._graph = None  # the frozen step's CUDA graph
        self.replays = 0  # frozen pushes served by replaying the graph

    @torch.inference_mode()
    def push(self, feat: np.ndarray) -> np.ndarray:
        """Add one frame's features; returns that frame's joints (J, 3)."""
        feat = np.asarray(feat, dtype=np.float32).reshape(-1)
        if feat.size != self.feature_dim:
            raise ValueError(
                f"feat has {feat.size} features, expected {self.feature_dim}")
        self._seen += 1
        if self._frozen is not None:
            return self._frozen_push(torch.from_numpy(feat))
        xnew = _project(self.params, torch.from_numpy(feat).to(self.device))
        if self._seen == 1:
            # edge-replicate warm start (constant window, so the roll below
            # is a no-op on content)
            self._xbuf = xnew[None, None, :].repeat(1, self.window, 1)
        self._xbuf = torch.cat([self._xbuf[:, 1:], xnew[None, None, :]], dim=1)
        phi = _temporal_net(self._xbuf, self.params["f_movie"], self.groups,
                            self.use_kernels, self.precise)
        joints = _regressor(phi[:, -1:], self.params["f_3D"], self.joints_num,
                            self.use_kernels, self.regressor_iters, self.precise)
        return joints[0, -1].cpu().numpy()

    def _frozen_step(self) -> None:
        """One frozen push over the static buffers: the features in
        `_io["feat"]` -> the window and the tap histories updated in place,
        the joints in `_io["joints"]`."""
        stats, state = self._frozen
        xnew = _project(self.params, self._io["feat"])
        self._xbuf[0, :-1] = self._xbuf[0, 1:].clone()
        self._xbuf[0, -1] = xnew
        u = xnew[None, :]
        for name in sorted_blocks(self.params["f_movie"]):
            u = _stream_block(u, self.params["f_movie"][name], state[name],
                              stats[name])
        joints = _regressor(u[:, None, :], self.params["f_3D"], self.joints_num,
                            self.use_kernels, self.regressor_iters, self.precise)
        self._io["joints"].copy_(joints[0, 0])

    def _frozen_push(self, feat: torch.Tensor) -> np.ndarray:
        self._io["feat"].copy_(feat)
        if self.device.type != "cuda":
            self._frozen_step()
        elif self._graph is None:
            # eager first, on a side stream as CUDA graph captures want: the
            # kernels' build, their attributes, the libraries' handles and
            # workspaces exist before the capture records the step
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._frozen_step()
            torch.cuda.current_stream(self.device).wait_stream(side)
            self._graph = self._capture()
        else:
            self._graph.replay()
            self.replays += 1
        return self._io["joints"].cpu().numpy()

    def _capture(self) -> torch.cuda.CUDAGraph:
        """Record the frozen step as one CUDA graph. A capture runs nothing:
        the buffers stay as the eager push left them. A capture that fails
        raises."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._frozen_step()
        return graph

    @torch.inference_mode()
    def freeze(self) -> None:
        """Pin GroupNorm statistics at the current window and switch push()
        to O(1) incremental compute. Requires at least one pushed frame;
        call again later to re-pin the statistics to a newer window."""
        if self._seen == 0:
            raise RuntimeError("no frames pushed yet")
        _, stats, state = _capture_freeze(self._xbuf, self.params["f_movie"],
                                          self.groups, self.eps)
        rep = self._xbuf.shape[-1] // self.groups
        # per channel once, not on every push
        stats = {name: {k.replace("mu", "mean"): v.repeat_interleave(rep)
                        for k, v in fs.items()} for name, fs in stats.items()}
        state = {name: {k: v.clone() for k, v in st.items()}
                 for name, st in state.items()}
        self._graph = None
        self._xbuf = self._xbuf.clone()
        self._io = {"feat": torch.empty(self.feature_dim, device=self.device),
                    "joints": torch.empty((self.joints_num, 3), device=self.device)}
        self._frozen = (stats, state)

    def unfreeze(self) -> None:
        """Return to exact sliding-statistics inference."""
        self._frozen = None
        self._io = None
        self._graph = None

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
            self.use_kernels, False, self.regressor_iters, self.precise)
        return future[0].cpu().numpy()

    @property
    def warm(self) -> bool:
        return self._seen >= self.window
