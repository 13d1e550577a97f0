"""Frozen copies of the draw rules that the reference works out again, so
that a later change to the program cannot move the yardstick:

- the dropout mask (h36x_torch/infer.py::dropout_mask on one device):
  uniform float32 draws from the step's generator, kept where below
  `keep`, scaled by 1 / keep;
- the training sampler's batches (h36x_torch/data/sampler.py::
  MixedShardBatchSampler with shuffle and drop_last): a `random.Random`
  seeded by seed + epoch shuffles the shards, then each shard's items, then
  draws each batch round-robin from `k` live shards, topped up from the
  others.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List

import torch


def dropout_mask(shape, keep: float, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    return (u < keep).to(torch.float32) / keep


def sampler_batches(buckets: Dict[int, List[int]], batch_size: int, k: int,
                    seed: int) -> Iterator[List[int]]:
    """The batches of one epoch, item indices; `buckets` maps each shard to
    its items in order, `seed` is the sampler's seed plus the epoch."""
    rng = random.Random(seed)
    order = list(buckets)
    rng.shuffle(order)
    table = {}
    for sid in order:
        items = list(buckets[sid])
        rng.shuffle(items)
        table[sid] = tuple(items)
    cursor = dict.fromkeys(order, 0)
    per_shard = batch_size // k

    def live():
        return [s for s in order if cursor[s] < len(table[s])]

    def take(sid, n, batch):
        lo = cursor[sid]
        hi = min(lo + n, len(table[sid]))
        batch.extend(table[sid][lo:hi])
        cursor[sid] = hi

    while True:
        shards = live()
        if not shards or sum(len(table[s]) - cursor[s] for s in shards) < batch_size:
            return
        batch: List[int] = []
        for sid in rng.sample(shards, min(k, len(shards))):
            take(sid, per_shard, batch)
        while len(batch) < batch_size:
            shards = live()
            if not shards:
                break
            take(rng.choice(shards), batch_size - len(batch), batch)
        if len(batch) == batch_size:
            yield batch


# ------------------------------------------------------------- extraction
# frozen from h36x_torch/geometry/crop.py, native/h36xio.cpp (crop-resize,
# jitter) and data/augment.py (jitter parameters, hue), so that the
# reference crops, jitters and flips the frames as the published pipeline
# does without calling the program

GRAY = (0.2989, 0.587, 0.114)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def square_crop(joints2d, img_h: int, img_w: int, scale: float = 1.6):
    """(top, left, side, side): centred on the joints' bounding box, side
    scale x its larger extent, clamped into the image, rounded."""
    import numpy as np

    pts = np.asarray(joints2d, dtype=np.float64).reshape(-1, 2)
    (x0, y0), (x1, y1) = pts.min(axis=0), pts.max(axis=0)
    side = scale * max(max(x1 - x0, 1.0), max(y1 - y0, 1.0))
    left = float(np.clip(0.5 * (x0 + x1) - 0.5 * side, 0.0, img_w - side))
    top = float(np.clip(0.5 * (y0 + y1) - 0.5 * side, 0.0, img_h - side))
    left_i, top_i, side_i = max(0, int(round(left))), max(0, int(round(top))), int(round(side))
    side_i = max(1, min(side_i, img_w - left_i, img_h - top_i))
    return (top_i, left_i, side_i, side_i)


def _grid(start: int, size: int, in_size: int, out: int, device):
    """Half-pixel bilinear sampling of [start, start + size) at `out`
    points, clamped to the crop and the image: (lo, hi, frac)."""
    scale = size / out
    lo, hi, frac = [], [], []
    for i in range(out):
        src = start + (i + 0.5) * scale - 0.5
        src = min(max(src, float(start)), float(start + size - 1))
        src = min(max(src, 0.0), float(in_size - 1))
        f = int(src // 1)
        lo.append(f)
        hi.append(min(f + 1, in_size - 1))
        frac.append(src - f)
    return (torch.tensor(lo, device=device), torch.tensor(hi, device=device),
            torch.tensor(frac, dtype=torch.float32, device=device))


def crop_resize(frames_u8: torch.Tensor, box, out: int) -> torch.Tensor:
    """(T, H, W, 3) uint8 -> (T, out, out, 3) uint8: rows, then columns, in
    float32, rounded half up."""
    top, left, side, _ = box
    _, h, w, _ = frames_u8.shape
    ly, hy, fy = _grid(top, side, h, out, frames_u8.device)
    lx, hx, fx = _grid(left, side, w, out, frames_u8.device)
    x = frames_u8.float()
    fy = fy[None, :, None, None]
    rows = (1.0 - fy) * x[:, ly] + fy * x[:, hy]
    fx = fx[None, None, :, None]
    v = (1.0 - fx) * rows[:, :, lx] + fx * rows[:, :, hx]
    return torch.clamp(v + 0.5, 0.0, 255.0).to(torch.uint8)


def jitter_params(rng, brightness=0.3, contrast=0.3, saturation=0.2, hue=0.05):
    """(order, brightness, contrast, saturation, hue factors) from a numpy
    Generator, in the published draw order."""
    order = rng.permutation(4)
    fb = rng.uniform(1.0 - brightness, 1.0 + brightness)
    fc = rng.uniform(1.0 - contrast, 1.0 + contrast)
    fs = rng.uniform(1.0 - saturation, 1.0 + saturation)
    fh = rng.uniform(-hue, hue)
    return order, fb, fc, fs, fh


def video_jitter_rng(seed: int, video: int):
    import numpy as np

    return np.random.default_rng(seed * 2_000_003 + video)


def _hue(v: torch.Tensor, shift: float) -> torch.Tensor:
    r, g, b = v[..., 0], v[..., 1], v[..., 2]
    maxc, minc = v.max(dim=-1).values, v.min(dim=-1).values
    span = maxc - minc
    sat = torch.where(maxc > 0, span / torch.clamp(maxc, min=1e-12), torch.zeros_like(maxc))
    safe = torch.clamp(span, min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(span > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    h = torch.remainder(h + shift, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = maxc * (1.0 - sat)
    q = maxc * (1.0 - f * sat)
    t = maxc * (1.0 - (1.0 - f) * sat)
    i = i.to(torch.int64) % 6
    pick = lambda opts: torch.stack(opts, dim=-1).gather(-1, i[..., None])[..., 0]  # noqa: E731
    return torch.stack([pick([maxc, q, p, p, t, maxc]), pick([t, maxc, maxc, q, p, p]),
                        pick([p, p, t, maxc, maxc, q])], dim=-1)


def jitter(frames_u8: torch.Tensor, params) -> torch.Tensor:
    """Brightness, contrast, saturation and hue in the drawn order, per
    frame, in float32 on [0, 1]; quantized once (round half to even)."""
    order, fb, fc, fs, fh = params
    gray_w = torch.tensor(GRAY, dtype=torch.float32, device=frames_u8.device)
    v = frames_u8.float() * (1.0 / 255.0)
    for op in order:
        if op == 0:
            v = torch.clamp(v * fb, 0.0, 1.0)
        elif op == 1:
            mean = (v @ gray_w).double().mean(dim=(-2, -1), keepdim=True).float()[..., None]
            v = torch.clamp(fc * v + (1.0 - fc) * mean, 0.0, 1.0)
        elif op == 2:
            v = torch.clamp(fs * v + (1.0 - fs) * (v @ gray_w)[..., None], 0.0, 1.0)
        else:
            v = _hue(v, fh)
    return torch.clamp(torch.round(v * 255.0), 0, 255).to(torch.uint8)


def normalize(frames_u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, 3, H, W) float32, ImageNet-normalized."""
    dev = frames_u8.device
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    return ((frames_u8.float() * (1.0 / 255.0) - mean) / std).permute(0, 3, 1, 2)
