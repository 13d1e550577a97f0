"""Tensor parallelism over a `model` mesh axis: the collectives XLA
inserts for h36x's sharding rules (h36x/parallel/mesh.py::_TP_RULES),
written by hand, for a model axis over processes (:class:`TensorParallel`)
or over one process's local devices (:class:`LocalTensorParallel`).

Over processes, each process of a model group of size m keeps the 1/m
slice of every split param (:func:`shard_model`; the dims are
:func:`h36x_torch.parallel.mesh.param_sharding_rules`'s) and runs the
plain ops on it. Three operations join the slices, each a
`torch.autograd.Function` over the model group:

- :func:`copy_to_model`: identity forward, all-reduce backward — where a
  replicated activation enters a column-split product, whose gradient
  with respect to it is a partial sum on each rank;
- :func:`gather_from_model`: all-gather forward along the split dimension,
  the rank's own slice backward — where a column-split output becomes a
  full-width activation again (every rank then computes the same thing);
- :func:`reduce_from_model`: all-reduce forward, identity backward — where
  a row-split product's partial sums are added.

Over local devices (:func:`shard_local`) the model keeps its full params
and runs as one autograd graph in one thread: each split product runs on
its own device, on its slice of the param (taken in the graph, moved to
that device: a no-op for a virtual device), the input moved there; the
column-split outputs come back to the group's first device and are
concatenated, the row-split partial sums are added there in model order.
Autograd's own cross-device copies carry the gradients back, and the full
params get the gradients of their slices, so the optimizer, the
checkpoints and the data replicas see one model. (Replicas meeting at a
barrier inside a backward would deadlock on one card: autograd runs a
device's backward on one worker thread.) Departure from h36x: the
replicated parts (GroupNorm, fc3) run once, on the first device, where
XLA runs them on every device of the group; and on distinct cards the
param slices move every step.

On either, the model runs as h36x's partitioned program does:
`input_proj` and every conv split by output channels and gathered to full
width before the next GroupNorm (GroupNorm and its params stay
replicated); `f_3D/fc1` split by columns with its output kept split, the
dropout mask sliced to match; `fc2` split by rows with the partial sums
added before its bias; `fc3` replicated. A param that the rules leave
replicated (a width the axis does not divide) runs whole. Over processes,
the gradients of replicated params come out equal on every rank of a
model group (tests/test_torch_tp.py checks it); the trainer averages all
gradients over the data axis only
(:func:`h36x_torch.parallel.distributed.mean_across_processes`).

Dropout masks are drawn on the full shape of the global batch from the same
generator on every rank (:func:`h36x_torch.infer.dropout_mask`), then
sliced, so a tensor-parallel run uses exactly the masks of a one-process
run. Only the plain ops run: h36x refuses `--optim.fused` with a model
axis, and so does the port.

Gloo's all-gather takes host tensors: on CUDA the gather is staged through
host memory (gloo moves CUDA tensors through the host for its all-reduce
too). `stats` counts the bytes each join moves.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from h36x_torch.infer import dropout_mask, sorted_blocks
from h36x_torch.ops.causal_conv import causal_conv1d
from h36x_torch.ops.temporal import reference_gn_relu
from h36x_torch.parallel.distributed import model_group, model_info
from h36x_torch.parallel.local import to_device
from h36x_torch.parallel.mesh import param_sharding_rules


class TensorParallel:
    """A model's split over a model axis of processes: `dims` maps each
    split param (state_dict name) to its split dimension; this process
    holds block `index` of `size`."""

    collective = True

    def __init__(self, dims: Dict[str, int], index: int, size: int, group=None):
        self.dims, self.index, self.size, self.group = dims, index, size, group
        self.stats = {"all_gather_bytes": 0, "all_reduce_bytes": 0}

    def split(self, name: str) -> bool:
        return name in self.dims

    def full_shape(self, name: str, shape) -> tuple:
        shape = list(shape)
        if name in self.dims:
            shape[self.dims[name]] *= self.size
        return tuple(shape)

    def local(self, name: str, full):
        """This process's block of the full array `full` of param `name`."""
        if name not in self.dims:
            return full
        dim = self.dims[name]
        n = full.shape[dim] // self.size
        return full[(slice(None),) * dim + (slice(self.index * n, (self.index + 1) * n),)]

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of param `name` from every rank's block of it (a
        collective of the model group; `t` itself where it is replicated)."""
        if name not in self.dims:
            return t
        return _all_gather(t.detach(), self.dims[name], self)

    # the forward's joins: lists over the model indices this process runs
    def inputs(self, x):
        return [copy_to_model(x, self)]

    def parts(self, name: str, t):
        return [t]

    def mask_parts(self, mask, n: int):
        return [mask[:, self.index * n:(self.index + 1) * n]]

    def join_columns(self, outs):
        return gather_from_model(outs[0], -1, self)

    def join_sum(self, outs):
        return reduce_from_model(outs[0], self)


class LocalTensorParallel(TensorParallel):
    """A model's split over a model axis of this process's `devices` (the
    module docstring): the model holds full params; each split product
    runs on its device."""

    collective = False

    def __init__(self, dims: Dict[str, int], devices, stats: Optional[dict] = None):
        super().__init__(dims, 0, len(devices))
        self.devices = list(devices)
        if stats is not None:
            self.stats = stats

    def on(self, devices) -> "LocalTensorParallel":
        """The same split over other devices (a data replica's model group;
        one `stats`)."""
        return LocalTensorParallel(self.dims, devices, self.stats)

    def full_shape(self, name: str, shape) -> tuple:
        return tuple(shape)

    def local(self, name: str, full):
        return full

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return t

    def inputs(self, x):
        return [to_device(x, d) for d in self.devices]

    def parts(self, name: str, t):
        if name not in self.dims:
            return [to_device(t, d) for d in self.devices]
        dim = self.dims[name]
        n = t.shape[dim] // self.size
        return [to_device(t.narrow(dim, i * n, n), d) for i, d in enumerate(self.devices)]

    def mask_parts(self, mask, n: int):
        return [to_device(mask[:, i * n:(i + 1) * n], d) for i, d in enumerate(self.devices)]

    def join_columns(self, outs):
        self.stats["all_gather_bytes"] += sum(o.numel() * o.element_size() for o in outs)
        return torch.cat([to_device(o, self.devices[0]) for o in outs], dim=-1)

    def join_sum(self, outs):
        self.stats["all_reduce_bytes"] += sum(o.numel() * o.element_size() for o in outs)
        total = to_device(outs[0], self.devices[0])
        for o in outs[1:]:
            total = total + to_device(o, self.devices[0])
        return total


def _all_gather(x: torch.Tensor, dim: int, tp: TensorParallel) -> torch.Tensor:
    host = x.contiguous() if x.device.type == "cpu" else x.cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(tp.size)]
    dist.all_gather(parts, host, group=tp.group)
    tp.stats["all_gather_bytes"] += host.numel() * host.element_size() * tp.size
    return torch.cat(parts, dim=dim).to(x.device)


def _all_reduce(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=tp.group)
    tp.stats["all_reduce_bytes"] += out.numel() * out.element_size()
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp, ctx.n = dim, tp, x.shape[dim]
        return _all_gather(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return g.narrow(ctx.dim, tp.index * ctx.n, ctx.n).contiguous(), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over the model group."""
    return _Copy.apply(x, tp)


def gather_from_model(x: torch.Tensor, dim: int, tp: TensorParallel) -> torch.Tensor:
    """Every rank's block concatenated along `dim`; the gradient's own block
    backward."""
    return _Gather.apply(x, dim, tp)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum over the model group; the gradient passed through."""
    return _Reduce.apply(x, tp)


def _split_dims(model, mesh) -> Dict[str, int]:
    dims = {}
    for name, p in model.named_parameters():
        dim = param_sharding_rules(name.replace(".", "/"), p, mesh)
        if dim is not None:
            dims[name] = dim
    return dims


def shard_model(model, mesh) -> TensorParallel:
    """Keep only this process's block of every param the rules split (in
    place: each Parameter's data becomes its slice) and attach the split to
    the model as `model.tp`, which routes its forward here. Build the
    optimizer afterwards, over the slices."""
    index, size = model_info()
    if size != mesh.model:
        raise ValueError(f"the model axis has {size} process(es), the mesh says "
                         f"{mesh.model} (init_groups first)")
    dims = _split_dims(model, mesh)
    tp = TensorParallel(dims, index, size, model_group())
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in dims:
                p.data = tp.local(name, p.data).contiguous().clone()
    model.tp = tp
    return tp


def shard_local(model, mesh, devices) -> LocalTensorParallel:
    """Split the model over a model axis of this process's `devices` (a
    group of :meth:`h36x_torch.parallel.mesh.Mesh.local_groups`) and attach
    the split as `model.tp`; the params stay whole, on `devices[0]`."""
    if len(devices) != mesh.model:
        raise ValueError(f"{len(devices)} local devices for a model axis of {mesh.model}")
    model.tp = LocalTensorParallel(_split_dims(model, mesh), devices)
    return model.tp


# -- the model on the slices ---------------------------------------------------------


def _cast(dtype, *ts):
    return ts if dtype is None else tuple(t.to(dtype) for t in ts)


def _dense(tp, x, p, name, dtype):
    """x @ kernel + bias (flax's Dense with its compute dtype); a
    column-split kernel's products joined to full width."""
    x, w, b = _cast(dtype, x, p["kernel"], p["bias"])
    if not tp.split(f"{name}.kernel"):
        return x @ w + b
    return tp.join_columns([xi @ wi + bi for xi, wi, bi in zip(
        tp.inputs(x), tp.parts(f"{name}.kernel", w), tp.parts(f"{name}.bias", b))])


def _conv(tp, h, p, name, dtype):
    h, k, b = _cast(dtype, h, p["kernel"], p["bias"])
    if not tp.split(f"{name}.kernel"):
        return causal_conv1d(h, k, b)
    return tp.join_columns([causal_conv1d(hi, ki, bi) for hi, ki, bi in zip(
        tp.inputs(h), tp.parts(f"{name}.kernel", k), tp.parts(f"{name}.bias", b))])


def _block(tp, x, p, name, groups, mask, dtype):
    """GN -> ReLU -> conv1 [* mask] -> GN -> ReLU -> conv2 + x, as
    :func:`h36x_torch.ops.temporal.reference_gn_relu_cconv` twice."""
    h = reference_gn_relu(x, p["gn1"]["scale"], p["gn1"]["bias"], groups, dtype=dtype)
    h = _conv(tp, h, p["conv1"], f"{name}.conv1", dtype)
    if mask is not None:
        h = h * mask
    h = reference_gn_relu(h, p["gn2"]["scale"], p["gn2"]["bias"], groups, dtype=dtype)
    out = _conv(tp, h, p["conv2"], f"{name}.conv2", dtype)
    return out + x.to(out.dtype)


def _net(tp, x, net, prefix, groups, generator, dropout, dtype):
    keep = 1.0 - dropout
    for name in sorted_blocks(net):
        p = net[name]
        mask = None
        if dropout > 0.0:
            width = tp.full_shape(f"{prefix}.{name}.conv1.kernel", p["conv1"]["kernel"].shape)[-1]
            mask = dropout_mask(x.shape[:2] + (width,), keep, generator, x)
        x = _block(tp, x, p, f"{prefix}.{name}", groups, mask, dtype)
    return x


def _regressor(tp, phi, reg, joints_num, iters, generator, dropout, dtype):
    """h36x's iterative JointRegressor: fc1 column-split (its output stays
    split, the dropout mask's columns sliced to match), fc2 row-split with
    the partial sums added before its bias, fc3 replicated."""
    b, t, d = phi.shape
    out_dim = joints_num * 3
    phi2d, w1, b1, w2, b2, w3, b3 = _cast(
        dtype, phi.reshape(b * t, d), reg["fc1"]["kernel"], reg["fc1"]["bias"],
        reg["fc2"]["kernel"], reg["fc2"]["bias"], reg["fc3"]["kernel"], reg["fc3"]["bias"])
    split = tp.split("f_3D.fc1.kernel")
    if split != tp.split("f_3D.fc2.kernel"):
        raise ValueError("f_3D/fc1's columns and fc2's rows must split together")
    hidden = tp.full_shape("f_3D.fc1.kernel", w1.shape)[1]
    if split:
        w1s, b1s = tp.parts("f_3D.fc1.kernel", w1), tp.parts("f_3D.fc1.bias", b1)
        w2s = tp.parts("f_3D.fc2.kernel", w2)
        n = w1s[0].shape[1]
    keep = 1.0 - dropout
    y = torch.zeros((b * t, out_dim), dtype=phi2d.dtype, device=phi.device)
    for _ in range(iters):
        inp = torch.cat([phi2d, y], dim=-1)
        if split:
            hs = [torch.relu(xi @ wi + bi) for xi, wi, bi in zip(tp.inputs(inp), w1s, b1s)]
            if dropout > 0.0:
                mask = dropout_mask((b * t, hidden), keep, generator, hs[0])
                hs = [h * m for h, m in zip(hs, tp.mask_parts(mask, n))]
            h = tp.join_sum([hi @ wi for hi, wi in zip(hs, w2s)]) + b2
        else:
            h = torch.relu(inp @ w1 + b1)
            if dropout > 0.0:
                h = h * dropout_mask((b * t, hidden), keep, generator, h)
            h = h @ w2 + b2
        h = torch.relu(h)
        y = y + h @ w3 + b3
    return y.reshape(b, t, joints_num, 3)


def _tree(model) -> dict:
    tree: dict = {}
    for key, value in model.named_parameters():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def forward(model, feats: torch.Tensor, predict_future: bool = False, *,
            train: bool = False, dropout_generator: Optional[torch.Generator] = None):
    """The model's forward on this process's slices, with its collectives
    (what :class:`h36x_torch.models.phd.PHDFor3DJoints` returns):

    - eval: (phi, phi_hat, joints_phi, joints_hat | None), f_AR run;
    - train (phase 1's loss path): (phi, joints_phi), f_AR not run;
    - train with predict_future (phase 2's): (phi, phi_hat, joints_hat).

    Masks are drawn in the one-process order: f_movie's blocks, f_AR's
    blocks (phase 2), the regressor's rounds."""
    tp = model.tp
    params = _tree(model)
    dtype = model.dtype
    dropout = model.dropout if train else 0.0
    if dropout > 0.0 and dropout_generator is None:
        raise ValueError("dropout > 0 needs a torch.Generator for its masks")
    kw = dict(joints_num=model.joints_num, iters=model.regressor_iters,
              generator=dropout_generator, dropout=dropout, dtype=dtype)

    def run():
        x = _dense(tp, feats, params["input_proj"], "input_proj", dtype)
        phi = _net(tp, x, params["f_movie"], "f_movie", model.groups,
                   dropout_generator, dropout, dtype)
        if train and not predict_future:
            return phi, _regressor(tp, phi, params["f_3D"], **kw)
        ar = _net(tp, phi, params["f_AR"], "f_AR", model.groups, dropout_generator,
                  dropout, dtype)
        phi_hat = torch.cat([torch.zeros_like(ar[:, :1]), ar[:, :-1]], dim=1)
        if train:
            return phi, phi_hat, _regressor(tp, phi_hat, params["f_3D"], **kw)
        joints_phi = _regressor(tp, phi, params["f_3D"], **kw)
        joints_hat = (_regressor(tp, phi_hat, params["f_3D"], **kw)
                      if predict_future else None)
        return phi, phi_hat, joints_phi, joints_hat

    if train:
        with torch.enable_grad():
            return run()
    with torch.inference_mode():
        return run()


def joints(model, feats: torch.Tensor) -> torch.Tensor:
    """Eval joints (B, T, J, 3): input_proj -> f_movie -> f_3D on the
    slices, f_AR not run (the trainer's eval, as
    :func:`h36x_torch.infer.make_fused_forward`)."""
    tp = model.tp
    params = _tree(model)
    with torch.inference_mode():
        x = _dense(tp, feats, params["input_proj"], "input_proj", model.dtype)
        phi = _net(tp, x, params["f_movie"], "f_movie", model.groups, None, 0.0,
                   model.dtype)
        return _regressor(tp, phi, params["f_3D"], model.joints_num,
                          model.regressor_iters, None, 0.0, model.dtype)
