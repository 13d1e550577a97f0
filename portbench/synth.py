"""Inputs and weights made from the seed, on the device, in a few large
calls: the same seed gives the same tensors, so the reference makes them
again rather than take them from the program.

Every draw has a generator of its own, seeded by :func:`sub_seed` from the
run's seed and a name, so that one part can be made again without the
others.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from portbench import seeds
from portbench.reference import phd as ref_phd
from portbench.seeds import sub_seed


def generator(seed: int, *names, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *names))


def phd_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every PHD parameter (:func:`portbench.reference.phd.param_specs`),
    float32, from one uniform draw split in spec order."""
    specs = ref_phd.param_specs(cfg)
    sizes = [torch.Size(shape).numel() for _, shape, _, _ in specs]
    u = torch.rand(sum(sizes), generator=generator(seed, "phd-weights", device=device),
                   device=device, dtype=torch.float32)
    out = {}
    for (name, shape, lo, hi), part in zip(specs, torch.split(u, sizes)):
        out[name] = (lo + (hi - lo) * part).reshape(shape)
    return out


def clip_rows(cfg: dict, seed: int, shard: int, clips: int, variants: int, device) -> dict:
    """One shard's rows (clips x variants, a clip's variants contiguous):
    features in [0, 1) as pooled ReLU features are, joints3d in mm
    (N(0, 300)), joints2d in pixels of a 1000-px frame, H36M-like
    intrinsics; float32 on `device`."""
    g = generator(seed, "phd-rows", shard, device=device)
    n, t, j = clips * variants, cfg["seq_len"], cfg["joints_num"]
    feats = torch.rand((n, t, cfg["feature_dim"]), generator=g, device=device)
    joints3d = 300.0 * torch.randn((n, t, j, 3), generator=g, device=device)
    joints2d = 1000.0 * torch.rand((n, t, j, 2), generator=g, device=device)
    K = torch.zeros((n, 3, 3), device=device)
    K[:, 0, 0], K[:, 1, 1], K[:, 2, 2] = 1145.0, 1144.0, 1.0
    K[:, 0, 2], K[:, 1, 2] = 500.0, 500.0
    return {"feats": feats, "joints3d": joints3d, "joints2d": joints2d, "K": K}


def store_layout(shards: int, clips: int, variants: int) -> List[dict]:
    """The index's clip entries: clip c in shard c // clips at row
    (c % clips) * variants, subject 1."""
    return [{"subject": 1, "action": "Synthetic", "cam": "cam_0", "shard_id": c // clips,
             "row": (c % clips) * variants, "clip_id": c}
            for c in range(shards * clips)]


def clip_bank(cfg: dict, seed: int, count: int) -> torch.Tensor:
    """The serving cells' clips (:func:`portbench.seeds.clip_bank`), on the
    host."""
    return torch.from_numpy(seeds.clip_bank(seed, count, cfg["seq_len"], cfg["feature_dim"]))


class ClipRef:
    """A clip's metadata, with the fields the extraction's clip sources
    carry (h36x_torch.data.clips.ClipIndex)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class SyntheticVideos:
    """An in-memory, video-structured clip source made from the seed (the
    interface of the extraction's video datasets: `clips`,
    `clip_annotations`, `video_groups`, `video_joints2d`, `open_video`,
    `__getitem__`): uint8 frames at Human3.6M's raw size, drawn on the card
    and held on the host, a person's 2D joints drifting slowly, H36M-like
    intrinsics; clips of `seq_len` frames every `stride`. It stands in for
    decoded video: the machine with the card has no OpenCV."""

    class Cursor:
        def __init__(self, frames):
            self.frames = frames

        def get(self, start, end):
            return self.frames[start:end]

        def close(self):
            pass

    def __init__(self, seed, videos, frames, raw, seq_len, stride, device="cpu"):
        self.frames = [video_frames(seed, v, frames, raw, device).cpu().numpy()
                       for v in range(videos)]
        self.j2d, self.j3d, self.clips = [], [], []
        for v in range(videos):
            j2d, j3d = video_joints(seed, v, frames, raw)
            self.j2d.append(j2d)
            self.j3d.append(j3d)
            cam = {"f": np.array([1145.0, 1144.0]), "c": np.array([raw / 2, raw / 2]),
                   "k": np.zeros(5), "rt": np.eye(3), "t": np.zeros(3)}
            for start in range(0, frames - seq_len + 1, stride):
                self.clips.append(ClipRef(
                    video_path=f"synthetic_{v}.mp4", gt_path=f"synthetic_{v}.pkl",
                    subject=1 + v, action="Walking", cam="cam_0", cam_params=cam,
                    start=start, end=start + seq_len, video_idx=v))

    def __len__(self):
        return len(self.clips)

    def subset(self, videos) -> "SyntheticVideos":
        """The same frames, with the clips of `videos` alone."""
        out = copy.copy(self)
        out.clips = [c for c in self.clips if c.video_idx in videos]
        return out

    def clip_annotations(self, i):
        ci = self.clips[i]
        v = ci.video_idx
        return (self.j3d[v][ci.start:ci.end].copy(), self.j2d[v][ci.start:ci.end].copy(),
                ci.cam_params, ci)

    def video_groups(self):
        groups = {}
        for i, ci in enumerate(self.clips):
            groups.setdefault(ci.video_idx, []).append(i)
        return [groups[v] for v in sorted(groups)]

    def video_joints2d(self, video_idx):
        return self.j2d[video_idx]

    def open_video(self, video_idx):
        return self.Cursor(self.frames[video_idx])

    def __getitem__(self, i):
        j3d, j2d, cam, ci = self.clip_annotations(i)
        return self.frames[ci.video_idx][ci.start:ci.end], j3d, j2d, cam, ci


def video_frames(seed: int, video: int, frames: int, raw: int, device) -> torch.Tensor:
    """A video's (frames, raw, raw, 3) uint8 frames, on `device`."""
    return torch.randint(0, 256, (frames, raw, raw, 3), dtype=torch.uint8, device=device,
                         generator=generator(seed, "video", video, device=device))


def video_joints(seed: int, video: int, frames: int, raw: int):
    """(2D joints (frames, 17, 2) in pixels, 3D joints (frames, 17, 3) in
    mm): a pose of 200 x 400 px about a point near the centre, drifting."""
    rng = np.random.default_rng(sub_seed(seed, "joints", video))
    centre = raw / 2 + rng.uniform(-100, 100, 2)
    pose = rng.uniform(-1, 1, (1, 17, 2)) * [100, 200]
    drift = np.cumsum(rng.normal(0, 2, (frames, 1, 2)), axis=0)
    j2d = (centre + pose + drift).astype(np.float32)
    j3d = (300 * rng.normal(size=(frames, 17, 3))).astype(np.float32)
    return j2d, j3d
