"""ViTPose-H's units of work (portbench/reference/vit_h.py's equations),
counted from shapes as portbench/roofline.py counts its own: the matrix
products' operations (2 per multiply-add) and each unit's boundary bytes,
its inputs read once and its outputs written once, the weights once a
batch. A unit's least time on the chip is the larger of operations over
989 TFLOP/s and bytes over 3.35 TB/s (roofline.Unit).

- embed: the uint8 crop's middle columns read, normalized, the patch
  convolution and the position added, tokens written;
- attention, once a block: LN1, qkv, softmax(q k^T / sqrt(head size)) v,
  proj and the residual add (the stream read and written);
- mlp, once a block: LN2, fc1, GELU, fc2 and the residual add;
- head: last_norm and the token mean (float32 features written).

Each is what one `h36x.vit.*` span of the program covers.
"""

from __future__ import annotations

from typing import List

from portbench.roofline import Unit


def vit_units(frames: int, s: dict, *, act: int = 2, w: int = 2, pixel: int = 1,
              feat: int = 4) -> List[Unit]:
    """The units of one batch of `frames` crops, `s` the model's sizes
    (reference.vit_h.sizes); `act`, `w`, `pixel` and `feat` the bytes of an
    activation, a weight, an input pixel and an output feature."""
    h, wd = s["img_size"]
    p, pad, d, m = s["patch"], s["padding"], s["dim"], s["mlp"]
    heads = s["heads"]
    t = ((h + 2 * pad - p) // p + 1) * ((wd + 2 * pad - p) // p + 1)
    rows = frames * t  # tokens
    stream = rows * d * act
    units = [Unit("embed", 2.0 * rows * d * 3 * p * p,
                  frames * h * wd * 3 * pixel + (d * 3 * p * p + d + (1 + t) * d) * w
                  + stream)]
    attn_flops = 2.0 * rows * d * (3 * d + d) + 2.0 * 2 * frames * heads * t * t * (d // heads)
    attn_weights = 3 * d * d + 3 * d + d * d + d + 2 * d
    mlp_weights = d * m + m + m * d + d + 2 * d
    for i in range(s["depth"]):
        units.append(Unit(f"block{i}.attention", attn_flops, 2 * stream + attn_weights * w))
        units.append(Unit(f"block{i}.mlp", 2.0 * rows * d * m * 2,
                          2 * stream + mlp_weights * w))
    units.append(Unit("head", 0.0, stream + 2 * d * w + frames * d * feat))
    return units


def attention_units(frames: int, s: dict) -> List[Unit]:
    """The attention units alone (one a block)."""
    return [u for u in vit_units(frames, s) if u.name.endswith(".attention")]
