"""Convert the reference's PyTorch weights into the port's params and back
(counterpart of h36x/models/torch_import.py).

Two kinds of weights come from the reference:

- a torchvision ResNet-50 state_dict (its IMAGENET1K_V2 backbone): the
  port's :class:`h36x_torch.models.resnet.ResNet50` keeps torchvision's
  names, so it loads one directly (:func:`h36x_torch.models.resnet.load_torchvision`);
  :func:`convert_torch_resnet50` goes through that same loader and gives
  h36x's flax variables {params, batch_stats} (HWIO kernels);
- a reference PHD training checkpoint (last.pt / best.pt, the model's
  state_dict under 'model'): :func:`convert_torch_phd` renames it into the
  flax-layout param tree that the port's PHD model, its checkpoints and
  h36x all read; :func:`export_phd_to_torch` is its inverse.

Values pass through as float32 numpy arrays, bit for bit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def _put(tree: dict, path, value) -> None:
    """Insert value at a nested path, creating intermediate dicts."""
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def convert_torch_resnet50(state_dict: dict) -> dict:
    """A torchvision ResNet-50 state_dict (torch tensors or numpy) -> h36x's
    flax variables {'params', 'batch_stats'}: OIHW conv weights as HWIO
    kernels, bn.{weight, bias} as params/{scale, bias},
    bn.running_{mean, var} as batch_stats/{mean, var},
    layer{L}.{B}.downsample.{0,1} as layer{L}_{B}/downsample_{conv,bn};
    the fc head is dropped. The keys are checked by loading them into the
    port's ResNet50 (:func:`h36x_torch.models.resnet.load_torchvision`)."""
    from h36x_torch.models.resnet import ResNet50, load_torchvision

    model = ResNet50(device="cpu")
    load_torchvision(model, {k: torch.as_tensor(np.array(v) if isinstance(v, np.ndarray)
                                                else v)
                             for k, v in state_dict.items()})
    params: dict = {}
    stats: dict = {}
    subs = {"downsample.0": "downsample_conv", "downsample.1": "downsample_bn"}
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        *module, field = key.split(".")
        if module[0].startswith("layer"):
            rest = ".".join(module[2:])
            module = [f"{module[0]}_{module[1]}", subs.get(rest, rest)]
        v = value.detach().cpu().numpy()
        if field == "weight" and v.ndim == 4:  # OIHW -> HWIO
            _put(params, module + ["kernel"], np.transpose(v, (2, 3, 1, 0)))
        elif field == "weight":
            _put(params, module + ["scale"], v)
        elif field == "bias":
            _put(params, module + ["bias"], v)
        elif field == "running_mean":
            _put(stats, module + ["mean"], v)
        else:
            _put(stats, module + ["var"], v)
    return {"params": params, "batch_stats": stats}


def load_torch_resnet50(path) -> dict:
    """Load a torch.save'd ResNet-50 state_dict file (a bare state_dict or
    {"state_dict": ...}) and convert it."""
    raw = torch.load(Path(path), map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return convert_torch_resnet50(raw)


# ---------------------------------------------------------------------------
# PHD pose-model checkpoints (the reference's last.pt / best.pt)
# ---------------------------------------------------------------------------


def convert_torch_phd(state_dict: dict) -> dict:
    """Reference PHD state_dict -> the flax-layout param tree (numpy leaves;
    :func:`h36x_torch.models.phd.params_from_flax` makes it a state_dict).

    The reference's keys:

        input_proj.{weight,bias}
        f_movie.blocks.{i}.{gn1,gn2}.{weight,bias}
        f_movie.blocks.{i}.{conv1,conv2}.conv.{weight,bias}
        f_AR.blocks.{i}...
        f_3D.mlp.{0,3,5}.{weight,bias}   (the Linear layers of its Sequential
                                          Linear, ReLU, Dropout, Linear, ReLU,
                                          Linear; index 6 is taken for the
                                          last one too)
        f_3D.y0                          (a zero buffer; dropped)

    Linear weights (out, in) become (in, out) kernels; Conv1d weights
    (out, in, k) become causal-conv kernels (k, in, out), taps oldest first
    in both."""
    params: dict = {}
    mlp_names = {"0": "fc1", "3": "fc2", "5": "fc3", "6": "fc3"}

    for key, value in state_dict.items():
        if key == "f_3D.y0":
            continue
        v = _to_numpy(value)
        parts = key.split(".")
        if parts[0] == "input_proj":
            if parts[1] == "weight":
                _put(params, ["input_proj", "kernel"], v.T)
            else:
                _put(params, ["input_proj", "bias"], v)
        elif parts[0] in ("f_movie", "f_AR"):
            block = f"block{parts[2]}"
            layer = parts[3]
            if layer in ("gn1", "gn2"):
                field = "scale" if parts[4] == "weight" else "bias"
                _put(params, [parts[0], block, layer, field], v)
            elif layer in ("conv1", "conv2"):
                if parts[-1] == "weight":
                    _put(params, [parts[0], block, layer, "kernel"],
                         np.transpose(v, (2, 1, 0)))
                else:
                    _put(params, [parts[0], block, layer, "bias"], v)
            else:
                raise KeyError(f"unrecognized PHD key {key!r}")
        elif parts[0] == "f_3D" and parts[1] == "mlp":
            name = mlp_names.get(parts[2])
            if name is None:
                raise KeyError(f"unrecognized regressor layer in {key!r}")
            if parts[3] == "weight":
                _put(params, ["f_3D", name, "kernel"], v.T)
            else:
                _put(params, ["f_3D", name, "bias"], v)
        else:
            raise KeyError(f"unrecognized PHD key {key!r}")
    return params


def export_phd_to_torch(params: dict) -> dict:
    """The flax-layout PHD param tree -> the reference's state_dict (numpy
    values; y0 as zeros): the inverse of :func:`convert_torch_phd`."""
    out: dict = {}
    out["input_proj.weight"] = np.asarray(params["input_proj"]["kernel"]).T
    out["input_proj.bias"] = np.asarray(params["input_proj"]["bias"])
    for mod in ("f_movie", "f_AR"):
        for block_name, block in params[mod].items():
            base = f"{mod}.blocks.{block_name.removeprefix('block')}"
            for gn in ("gn1", "gn2"):
                out[f"{base}.{gn}.weight"] = np.asarray(block[gn]["scale"])
                out[f"{base}.{gn}.bias"] = np.asarray(block[gn]["bias"])
            for conv in ("conv1", "conv2"):
                out[f"{base}.{conv}.conv.weight"] = np.transpose(
                    np.asarray(block[conv]["kernel"]), (2, 1, 0))
                out[f"{base}.{conv}.conv.bias"] = np.asarray(block[conv]["bias"])
    for name, idx in (("fc1", "0"), ("fc2", "3"), ("fc3", "5")):
        out[f"f_3D.mlp.{idx}.weight"] = np.asarray(params["f_3D"][name]["kernel"]).T
        out[f"f_3D.mlp.{idx}.bias"] = np.asarray(params["f_3D"][name]["bias"])
    out["f_3D.y0"] = np.zeros(np.shape(params["f_3D"]["fc3"]["kernel"])[1],
                              dtype=np.float32)
    return out


def load_torch_phd(path) -> dict:
    """Load a reference training checkpoint (last.pt / best.pt, or a bare
    state_dict) with weights_only=True and convert the model's weights."""
    raw = torch.load(Path(path), map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "model" in raw:
        raw = raw["model"]
    return convert_torch_phd(raw)


def infer_model_config(params: dict) -> dict:
    """The architecture fields that the shapes of a converted PHD param
    tree show (ModelConfig names, ready for a manifest's config.model):
    input_proj (feature_dim, latent_dim), the f_movie / f_AR block counts,
    the conv taps, the regressor's widths (fc1 in = latent + 3J, fc3 out =
    3J). `groups` and `regressor_iters` do not show in any shape and are
    not returned: callers supply them (the reference's are 32 and 3)."""
    feature_dim, latent_dim = (int(s) for s in np.shape(params["input_proj"]["kernel"]))
    joints3 = int(np.shape(params["f_3D"]["fc3"]["kernel"])[1])
    if joints3 % 3:
        raise ValueError(f"f_3D.fc3 output {joints3} is not 3*J")
    block0 = params["f_movie"]["block0"]["conv1"]["kernel"]
    return {
        "latent_dim": latent_dim,
        "feature_dim": feature_dim,
        "joints_num": joints3 // 3,
        "num_blocks": sum(k.startswith("block") for k in params["f_movie"]),
        "ar_num_blocks": sum(k.startswith("block") for k in params["f_AR"]),
        "kernel_size": int(np.shape(block0)[0]),
        "regressor_hidden": int(np.shape(params["f_3D"]["fc1"]["kernel"])[1]),
    }
