"""HRNet-W48-C's units of work (portbench/reference/hrnet_w48.py's
equations), counted from shapes as portbench/roofline.py counts its own:
the convolutions' operations (2 per multiply-add) and each unit's boundary
bytes, its inputs read once and its outputs written once, the weights (a
conv's kernel and bias, a batch norm's four vectors) once a batch. A
unit's least time on the chip is the larger of operations over 989 TFLOP/s
and bytes over 3.35 TB/s (roofline.Unit).

- stem: the uint8 crop's middle columns read, normalized, both stem convs
  and stage 1's Bottlenecks, stage 1's stream written;
- transition1..3: the convs that make each new branch (and change a kept
  one's width), from the streams they read to the branches they write;
- stage<s>.<m>.branches: a module's BasicBlocks, every branch's stream
  read and written;
- stage<s>.<m>.fuse: a module's exchange, every branch's stream read and
  every fused stream written;
- head: the incre Bottlenecks, the downsamp convs, the final layer and
  the mean, float32 features written.

Each is what one `h36x.hrnet.*` span of the program covers.
"""

from __future__ import annotations

from typing import List, Tuple

from portbench.roofline import Unit


def _conv(c_in: int, c_out: int, k: int, hw: Tuple[int, int], bias: bool = False):
    """(multiply-adds a frame, weight elements) of a conv with its batch
    norm, `hw` its output's size."""
    return c_in * c_out * k * k * hw[0] * hw[1], c_out * c_in * k * k + (c_out if bias else 0) \
        + 4 * c_out


def _bottleneck(c_in: int, width: int, hw):
    parts = [_conv(c_in, width, 1, hw), _conv(width, width, 3, hw), _conv(width, 4 * width, 1, hw)]
    if c_in != 4 * width:
        parts.append(_conv(c_in, 4 * width, 1, hw))
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def _unit(name, frames, parts, in_elems, out_bytes, act, w):
    macs = sum(p[0] for p in parts)
    weights = sum(p[1] for p in parts)
    return Unit(name, 2.0 * frames * macs, frames * in_elems * act + weights * w + out_bytes)


def hrnet_units(frames: int, s: dict, *, act: int = 2, w: int = 2, pixel: int = 1,
                feat: int = 4) -> List[Unit]:
    """The units of one batch of `frames` crops, `s` the model's sizes
    (reference.hrnet_w48.sizes); `act`, `w`, `pixel` and `feat` the bytes of
    an activation, a weight, an input pixel and an output feature."""
    h, wd = s["img_size"]
    ch, head = s["channels"], s["head"]
    res = [(h // 4 >> i, wd // 4 >> i) for i in range(len(ch))]  # branch i's size
    half = (h // 2, wd // 2)

    def size(c, hw):
        return c * hw[0] * hw[1]

    stem = [_conv(3, s["stem"], 3, half), _conv(s["stem"], s["stem"], 3, res[0])]
    c_in = s["stem"]
    for _ in range(s["stage1_blocks"]):
        stem.append(_bottleneck(c_in, s["stage1_width"], res[0]))
        c_in = 4 * s["stage1_width"]
    units = [Unit("stem", 2.0 * frames * sum(p[0] for p in stem),
                  frames * h * wd * 3 * pixel + sum(p[1] for p in stem) * w
                  + frames * size(c_in, res[0]) * act)]
    pre = [c_in]
    for st, n_modules in enumerate(s["modules"], start=2):
        cur = ch[:st]
        parts, reads, writes = [], set(), 0
        for i, c in enumerate(cur):
            if i < len(pre):
                if c != pre[i]:
                    parts.append(_conv(pre[i], c, 3, res[i]))
                    reads.add(i)
                    writes += size(c, res[i])
                continue
            for k in range(i - len(pre) + 1):
                out = c if k == i - len(pre) else pre[-1]
                parts.append(_conv(pre[-1], out, 3, res[len(pre) + k]))
            reads.add(len(pre) - 1)
            writes += size(c, res[i])
        in_elems = sum(size(pre[i], res[i]) for i in reads)
        units.append(_unit(f"transition{st - 1}", frames, parts, in_elems,
                           frames * writes * act, act, w))
        streams = sum(size(c, res[i]) for i, c in enumerate(cur))
        for m in range(n_modules):
            parts = [_conv(c, c, 3, res[i]) for i, c in enumerate(cur)
                     for _ in range(2 * s["blocks"])]
            units.append(_unit(f"stage{st}.{m}.branches", frames, parts, streams,
                               frames * streams * act, act, w))
            parts = []
            for i in range(st):
                for j in range(st):
                    if j > i:
                        parts.append(_conv(ch[j], ch[i], 1, res[j]))
                    for k in range(i - j):
                        out = ch[i] if k == i - j - 1 else ch[j]
                        parts.append(_conv(ch[j], out, 3, res[j + k + 1]))
            units.append(_unit(f"stage{st}.{m}.fuse", frames, parts, streams,
                               frames * streams * act, act, w))
        pre = list(cur)
    parts = [_bottleneck(c, width, res[i]) for i, (c, width) in enumerate(zip(ch, head))]
    parts += [_conv(4 * head[i], 4 * head[i + 1], 3, res[i + 1], bias=True)
              for i in range(len(head) - 1)]
    parts.append(_conv(4 * head[-1], s["feature"], 1, res[-1], bias=True))
    units.append(_unit("head", frames, parts, sum(size(c, res[i]) for i, c in enumerate(ch)),
                       frames * s["feature"] * feat, act, w))
    return units


def branch_units(frames: int, s: dict) -> List[Unit]:
    """The modules' BasicBlock units alone (one a module)."""
    return [u for u in hrnet_units(frames, s) if u.name.endswith(".branches")]


def fuse_units(frames: int, s: dict) -> List[Unit]:
    """The modules' exchange units alone (one a module)."""
    return [u for u in hrnet_units(frames, s) if u.name.endswith(".fuse")]
