"""Deployment artifacts for the PHD model via torch.export (counterpart of
h36x/export.py).

A trained model's forward, or its autoregressive rollout, is traced by
`torch.export.export` with the parameters baked in, and saved by
`torch.export.save` as one `.pt2` file. A serving host runs it with
PyTorch alone (no h36x_torch, no model code, no checkpoint):

    ep = torch.export.load("phd.pt2")
    ep = torch.export.passes.move_to_device_pass(ep, "cuda")
    with torch.inference_mode():
        joints = ep.module()(feats)      # feats (B, seq_len, feature_dim) f32

Design choices (h36x's, where torch has them):

- **Params are baked in** as constants of the program, detached first, so
  that export lifts no tensor that requires grad. The file is the whole
  deployable unit.
- **The batch dimension is symbolic** by default (`torch.export.Dim`), so
  one artifact serves any batch size; `batch=` fixes it. Time stays fixed:
  GroupNorm statistics and the rollout buffer are built for the training
  window.
- **The compute is the plain engine** (`use_kernels=False`): the program
  holds only aten ops, and no ctypes call into the hand-written CUDA
  kernels, which torch.export cannot trace and which would tie the file to
  one build of them. This is h36x's `use_pallas=False` ("the only one that
  lowers portably"); on the card those ops run on cuBLAS and PyTorch's own
  kernels.
- **compute_dtype=torch.bfloat16** casts every float param (the file
  halves) and the features to bfloat16, and the outputs back to float32:
  the plain engine then runs in bfloat16 throughout, GroupNorm statistics
  included, as h36x's XLA artifact does. The interface stays f32 in, f32
  out.
- **Platforms** mean nothing to torch.export: a program runs on whichever
  device its constants are moved to. `platforms` ("cpu" and/or "cuda") is
  recorded in the artifact's metadata, and any other name is refused.

`load_artifact(src, device)` moves the program and every constant onto
`device` (cuda unless the caller asks for another), so one file serves the
CPU tests and the card. The `.pt2` format is PyTorch's and not promised
across its versions: write and read an artifact with one torch version.
h36x's StableHLO artifacts are not read.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from h36x_torch.infer import _movie, _regressor
from h36x_torch.serve import _rollout
from h36x_torch.utils.runtime import resolve_device

PLATFORMS = ("cpu", "cuda")
_META = "h36x_torch.json"  # the artifact's metadata, an extra file of the .pt2


def _platforms(platforms: Sequence[str]) -> list:
    names = [p.strip() for p in platforms if p.strip()]
    bad = [p for p in names if p not in PLATFORMS]
    if bad or not names:
        raise ValueError(
            f"platforms {names}: a torch.export artifact runs on "
            f"{' or '.join(PLATFORMS)} (h36x's 'tpu' has no counterpart here)")
    return [p for p in PLATFORMS if p in names]


def _cast_params(params, compute_dtype: Optional[torch.dtype] = None):
    """params (a flax-layout tree of tensors or numpy arrays) as detached
    tensors that require no grad, every float one cast to compute_dtype when
    one is given — before tracing, so the baked-in constants shrink too."""
    if isinstance(params, dict):
        return {k: _cast_params(v, compute_dtype) for k, v in params.items()}
    if isinstance(params, np.ndarray):
        params = torch.from_numpy(np.array(params))
    t = torch.as_tensor(params).detach()
    if compute_dtype is not None and t.is_floating_point():
        t = t.to(compute_dtype)
    return t


class _Forward(torch.nn.Module):
    """feats -> joints (B, T, J, 3) float32 over the plain engine. The params
    are a plain dict attribute: export lifts its tensors as constants."""

    def __init__(self, params, compute_dtype, joints_num, groups,
                 regressor_iters):
        super().__init__()
        self.params = params
        self.compute_dtype = compute_dtype
        self.joints_num, self.groups = joints_num, groups
        self.regressor_iters = regressor_iters

    def forward(self, feats):
        if self.compute_dtype is not None:
            feats = feats.to(self.compute_dtype)
        phi = _movie(self.params, feats, self.groups, False)
        joints = _regressor(phi, self.params["f_3D"], self.joints_num, False,
                            self.regressor_iters)
        return joints.float()


class _Rollout(_Forward):
    """feats -> (joints_ctx (B, T, J, 3), joints_future (B, steps, J, 3)),
    float32, over the plain rollout (masked GroupNorm over a fixed buffer)."""

    def __init__(self, params, compute_dtype, joints_num, groups,
                 regressor_iters, steps):
        super().__init__(params, compute_dtype, joints_num, groups,
                         regressor_iters)
        self.steps = steps

    def forward(self, feats):
        if self.compute_dtype is not None:
            feats = feats.to(self.compute_dtype)
        ctx, fut, _ = _rollout(self.params, feats, self.steps, self.joints_num,
                               self.groups, False, self.regressor_iters)
        return ctx.float(), fut.float()


def _aval(t) -> str:
    """'float32[b,40,2048]' for a traced tensor (a symbolic dim is 'b')."""
    dims = ",".join(str(d) if isinstance(d, int) else "b" for d in t.shape)
    return f"{str(t.dtype).removeprefix('torch.')}[{dims}]"


def _export(module, batch, seq_len, feature_dim, dtype, platforms) -> bytes:
    platforms = _platforms(platforms)
    device = next(iter(_leaves(module.params))).device
    # an example batch of 2 for a symbolic batch: torch.export specialises
    # an example dimension of 0 or 1
    example = torch.zeros((2 if batch is None else batch, seq_len, feature_dim),
                          dtype=dtype, device=device)
    dynamic = None if batch is not None else {
        "feats": {0: torch.export.Dim("b", min=1)}}
    ep = torch.export.export(module, (example,), dynamic_shapes=dynamic)
    nodes = {n.name: n for n in ep.graph.nodes}
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    user_out = set(ep.graph_signature.user_outputs)
    meta = {
        "platforms": platforms,
        "in_avals": [_aval(nodes[n].meta["val"])
                     for n in ep.graph_signature.user_inputs],
        "out_avals": [_aval(a.meta["val"]) for a in out_node.args[0]
                      if a.name in user_out],
        "input_shape": [batch, seq_len, feature_dim],
    }
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def export_forward(
    params,
    *,
    seq_len: int = 40,
    feature_dim: int = 2048,
    joints_num: int = 17,
    groups: int = 32,
    batch: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    compute_dtype: Optional[torch.dtype] = None,
    platforms: Sequence[str] = PLATFORMS,
    regressor_iters: int = 3,
) -> bytes:
    """Serialize `feats (B, seq_len, feature_dim) -> joints (B, T, J, 3)`
    with `params` (a flax-layout tree, tensors or arrays, on the device to
    trace on) baked in. batch=None exports a symbolic batch dimension.
    compute_dtype=torch.bfloat16 bakes bf16 weights and computes in bf16
    (half the file); the interface stays f32 in, f32 out. regressor_iters
    must match the checkpoint's training config."""
    module = _Forward(_cast_params(params, compute_dtype), compute_dtype,
                      joints_num, groups, regressor_iters)
    return _export(module, batch, seq_len, feature_dim, dtype, platforms)


def export_rollout(
    params,
    *,
    steps: int,
    seq_len: int = 40,
    feature_dim: int = 2048,
    joints_num: int = 17,
    groups: int = 32,
    batch: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    compute_dtype: Optional[torch.dtype] = None,
    platforms: Sequence[str] = PLATFORMS,
    regressor_iters: int = 3,
) -> bytes:
    """Serialize the AR rollout: `feats (B, seq_len, feature_dim) ->
    (joints_ctx (B, T, J, 3), joints_future (B, steps, J, 3))`. `steps`
    future frames are baked in (one artifact per forecast horizon);
    compute_dtype and regressor_iters as in :func:`export_forward`."""
    module = _Rollout(_cast_params(params, compute_dtype), compute_dtype,
                      joints_num, groups, regressor_iters, steps)
    return _export(module, batch, seq_len, feature_dim, dtype, platforms)


def _read(src) -> bytes:
    return Path(src).read_bytes() if isinstance(src, (str, Path)) else bytes(src)


def _meta(blob: bytes) -> dict:
    """The artifact's metadata, read from the .pt2 zip archive without
    deserializing the program."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        names = [n for n in z.namelist() if n.rsplit("/", 1)[-1] == _META]
        if len(names) != 1:
            raise ValueError(f"not an h36x_torch artifact: no {_META} in it")
        return json.loads(z.read(names[0]))


class LoadedArtifact:
    """An artifact's program on one device. Call it on feats (B, T, F), a
    float32 tensor or array: joints (a tensor on `device`), or (ctx,
    future) for a rollout, computed under torch.inference_mode().
    `program` is the moved ExportedProgram; :meth:`tensors` its constants
    and state; `input_shape` as :func:`artifact_input_shape` gives it."""

    def __init__(self, program, device: torch.device, input_shape: tuple):
        self.program = program
        self.device = device
        self.input_shape = input_shape
        self._module = program.module()

    def tensors(self) -> list:
        return [*self.program.state_dict.values(), *self.program.constants.values()]

    def __call__(self, feats):
        with torch.inference_mode():
            return self._module(torch.as_tensor(feats, device=self.device))


def load_artifact(src, device=None) -> LoadedArtifact:
    """Rehydrate an artifact (bytes or a path) onto `device` (cuda unless
    the caller asks for another; without CUDA that raises): the program and
    every constant are moved there. Needs only torch, not h36x_torch."""
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    blob = _read(src)
    ep = torch.export.load(io.BytesIO(blob))
    return LoadedArtifact(move_to_device_pass(ep, dev), dev,
                          _input_shape(_meta(blob)))


def artifact_info(src) -> dict:
    """Introspect an artifact: platforms, input/output shapes and dtypes,
    size in bytes."""
    blob = _read(src)
    meta = _meta(blob)
    return {"platforms": meta["platforms"], "in_avals": meta["in_avals"],
            "out_avals": meta["out_avals"], "nbytes": len(blob)}


def artifact_input_shape(src) -> tuple:
    """(batch, seq_len, feature_dim) of the artifact's feature input; batch
    is None for a symbolic batch dimension (the default). The daemon's CLI
    takes its wire shapes from here."""
    return _input_shape(_meta(_read(src)))


def _input_shape(meta: dict) -> tuple:
    b, t, d = meta["input_shape"]
    return (b, int(t), int(d))


def save_artifact(blob: bytes, path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # pid-suffixed so two exporters racing on the same path each publish a
    # complete blob (a shared ".tmp" lets A rename the file B is mid-write)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return path
