"""The yardstick's arithmetic: the peaks of one NVIDIA H100 SXM and the
operations and boundary bytes of each unit of work, counted from shapes.

A unit is a part of a model at the grain of the port's kernels: PHD's input
projection, each GroupNorm -> ReLU -> causal conv half of a temporal block,
the iterative regressor and AdamW; ResNet-50's stem, each bottleneck and
the pooling. What a unit counts is its work, never the kernel that does it:
the matrix products' operations (2 per multiply-add) and the bytes of each
input read once and each output written once. Its least time on the chip
is the larger of operations / PEAK_FLOPS and bytes / PEAK_BYTES. A unit
counts one batch: each row's activations once a row, the weights once a
batch, so work done in batches is summed batch by batch (`over_batches`).

The peak is the dense bfloat16 tensor-core rate whatever a path's
precision: the port emulates float32 on bf16 tensor cores, so a lower peak
would let a correct kernel read above 100 %.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Tuple

PEAK_FLOPS = 989e12  # dense bf16 tensor cores, NVIDIA H100 SXM data sheet
PEAK_BYTES = 3.35e12  # HBM3


@dataclass(frozen=True)
class Unit:
    name: str
    flops: float
    nbytes: float

    @property
    def bound_s(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.nbytes / PEAK_BYTES)


def total_flops(units: Iterable[Unit]) -> float:
    return float(sum(u.flops for u in units))


def total_bound_s(units: Iterable[Unit]) -> float:
    return float(sum(u.bound_s for u in units))


def batch_sizes(items: int, per_batch: int) -> Dict[int, int]:
    """{batch size: batches} of `items` cut into batches of `per_batch`,
    the last one holding the rest."""
    full, rest = divmod(int(items), int(per_batch))
    sizes = {int(per_batch): full} if full else {}
    if rest:
        sizes[rest] = 1
    return sizes


def over_batches(units_of: Callable[[int], List[Unit]],
                 sizes: Dict[int, int]) -> Tuple[float, float]:
    """(operations, least seconds) of the batches in `sizes` ({rows: count}),
    `units_of(rows)` the units of one batch of `rows`."""
    flops = bound = 0.0
    for rows, count in sizes.items():
        units = units_of(rows)
        flops += count * total_flops(units)
        bound += count * total_bound_s(units)
    return flops, bound


# --------------------------------------------------------------------- PHD

def _temporal_half(n, d, o, k, act, w, residual, mask):
    """GN -> ReLU -> causal conv (k taps, d -> o) over n rows, forward."""
    flops = 2.0 * n * k * d * o
    nbytes = (n * d * act + (k * d * o + o + 2 * d) * w + n * o * act
              + (n * o * act if residual else 0) + (n * d * act if mask else 0))
    return flops, nbytes


def _regressor_weights(d, h, out):
    return (d + out) * h + h + h * h + h + h * out + out


def phd_forward_units(cfg: dict, batch: int, *, act: int = 4, w: int = 4,
                      feat: int = 4, dropout_masks: bool = False) -> List[Unit]:
    """input_proj -> f_movie's halves -> f_3D over `batch` clips of
    cfg["seq_len"] frames; `act`, `w`, `feat` the bytes of an activation, a
    weight and an input feature."""
    n = batch * cfg["seq_len"]
    f, d, k = cfg["feature_dim"], cfg["latent_dim"], cfg["kernel_size"]
    h, out, iters = cfg["regressor_hidden"], 3 * cfg["joints_num"], cfg["regressor_iters"]
    units = [Unit("input_proj", 2.0 * n * f * d,
                  n * f * feat + (f * d + d) * w + n * d * act)]
    for b in range(cfg["num_blocks"]):
        for half in (1, 2):
            fl, nb = _temporal_half(n, d, d, k, act, w, residual=half == 2,
                                    mask=dropout_masks and half == 2)
            units.append(Unit(f"f_movie.block{b}.half{half}", fl, nb))
    units.append(Unit("f_3D", iters * 2.0 * n * ((d + out) * h + h * h + h * out),
                      n * d * act + _regressor_weights(d, h, out) * w + n * out * act))
    return units


def phd_trainable_params(cfg: dict) -> int:
    """Phase 1's trainable parameters: input_proj, f_movie, f_3D (f_AR is
    frozen)."""
    f, d, k = cfg["feature_dim"], cfg["latent_dim"], cfg["kernel_size"]
    h, out = cfg["regressor_hidden"], 3 * cfg["joints_num"]
    block = 2 * (k * d * d + d + 2 * d)
    return f * d + d + cfg["num_blocks"] * block + _regressor_weights(d, h, out)


def phd_train_step_units(cfg: dict, batch: int) -> List[Unit]:
    """One phase-1 step in float32: the forward with dropout masks, the
    backward of each unit (the input and weight gradients; input_proj only
    its weight gradient, the features are no parameter) and AdamW."""
    fwd = phd_forward_units(cfg, batch, dropout_masks=cfg["dropout"] > 0.0)
    n = batch * cfg["seq_len"]
    f, d, k = cfg["feature_dim"], cfg["latent_dim"], cfg["kernel_size"]
    h, out = cfg["regressor_hidden"], 3 * cfg["joints_num"]
    a = 4
    bwd = [Unit("input_proj.bwd", 2.0 * n * f * d,
                n * f * a + n * d * a + (f * d + d) * a)]
    for b in range(cfg["num_blocks"]):
        for half in (1, 2):
            mask = cfg["dropout"] > 0.0 and half == 2
            bwd.append(Unit(f"f_movie.block{b}.half{half}.bwd", 4.0 * n * k * d * d,
                            (3 * n * d + 2 * (k * d * d + d + 2 * d)) * a
                            + (n * d * a if mask else 0)))
    reg = fwd[-1]
    bwd.append(Unit("f_3D.bwd", 2.0 * reg.flops,
                    (2 * n * d + n * out + 2 * _regressor_weights(d, h, out)) * a))
    # AdamW: read p, g, mu, nu; write p, mu, nu
    adam = Unit("adamw", 0.0, 28.0 * phd_trainable_params(cfg))
    return fwd + bwd + [adam]


# ---------------------------------------------------------------- ResNet-50

def resnet50_units(frames: int, hw: int = 224, *, act: int = 2, w: int = 2,
                   pixel: int = 1) -> List[Unit]:
    """torchvision's ResNet-50 (v1.5) trunk to the pooled 2048-D feature,
    over `frames` frames of hw x hw x 3: the stem (7x7/2 conv and 3x3/2 max
    pool), each bottleneck (a stage's first, with the projection and the
    stride, is the transition) and the pooling; batch norm folded into the
    convolutions."""
    s = hw // 2  # the stem conv's output side
    p = s // 2  # after the max pool
    units = [Unit("stem", 2.0 * frames * s * s * 7 * 7 * 3 * 64,
                  frames * hw * hw * 3 * pixel + (7 * 7 * 3 * 64 + 64) * w
                  + frames * p * p * 64 * act)]
    side, c_in = p, 64
    for stage, blocks in enumerate((3, 4, 6, 3)):
        m = 64 * 2 ** stage
        for blk in range(blocks):
            stride = 2 if stage > 0 and blk == 0 else 1
            o = side // stride
            macs = side * side * c_in * m + o * o * 9 * m * m + o * o * m * 4 * m
            weights = c_in * m + 9 * m * m + 4 * m * m + 6 * m
            if blk == 0:
                macs += o * o * c_in * 4 * m
                weights += c_in * 4 * m + 4 * m
            kind = "transition" if blk == 0 else "bottleneck"
            units.append(Unit(f"layer{stage + 1}.{blk}.{kind}", 2.0 * frames * macs,
                              frames * (side * side * c_in + o * o * 4 * m) * act
                              + weights * w))
            side, c_in = o, 4 * m
    units.append(Unit("pool", 0.0, frames * (side * side * c_in * act + c_in * 4)))
    return units
