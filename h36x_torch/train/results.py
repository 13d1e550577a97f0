"""Test-set inference + artifact dump (counterpart of h36x/train/results.py).

Evaluate the trained model on the test subject (loss/MPJPE in m), then dump
ONE batch to a compressed NPZ containing the raw video clips (reloaded from
the ingested mp4s via each row's meta), GT/predicted 3D joints, 2D joints,
K, meta, and the test metrics, under h36x's field names.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch

from h36x_torch.data.features import FeatureClipDataset
from h36x_torch.data.shards import BF16_BITS, as_tensor
from h36x_torch.data.sampler import SequentialBatchSampler
from h36x_torch.parallel.local import Replicas, replica_of
from h36x_torch.parallel.mesh import data_axis_size
from h36x_torch.parallel.tensor import shard_local
from h36x_torch.train.step import make_forward, make_weighted_eval_step


def find_video_path(preprocessed_root: str, meta: dict) -> str:
    """Locate the ingested mp4 for a feature row's meta."""
    subject = int(meta["subject"])
    action = str(meta["action"])
    cam = str(meta["cam"])
    if not cam.startswith("cam_"):
        cam = f"cam_{cam}"
    cam_dir = os.path.join(preprocessed_root, f"S{subject}", action, cam)
    mp4s = sorted(glob.glob(os.path.join(cam_dir, "*.mp4")))
    if not mp4s:
        raise FileNotFoundError(f"no mp4 under {cam_dir}")
    return mp4s[0]


def pad_or_trim_video(video: np.ndarray, target_t: int) -> np.ndarray:
    """(T,H,W,3) -> exactly target_t frames, padding with the last frame."""
    t = video.shape[0]
    if t == target_t:
        return video
    if t > target_t:
        return video[:target_t]
    pad = np.repeat(video[-1:], target_t - t, axis=0)
    return np.concatenate([video, pad], axis=0)


def resize_video_hw(video: np.ndarray, out_hw: Optional[int]) -> np.ndarray:
    """(T,H,W,3) u8 -> (T,out,out,3) u8 bilinear (host, OpenCV)."""
    if out_hw is None:
        return video
    import cv2

    out = np.empty((video.shape[0], out_hw, out_hw, 3), np.uint8)
    for t in range(video.shape[0]):
        out[t] = cv2.resize(video[t], (out_hw, out_hw), interpolation=cv2.INTER_LINEAR)
    return out


def load_video_clip_from_meta(
    preprocessed_root: str, meta: dict, seq_len: int, out_hw: Optional[int] = None
) -> np.ndarray:
    """Re-decode the raw clip a feature row came from."""
    from h36x_torch.data.clips import decode_clip

    path = find_video_path(preprocessed_root, meta)
    start, end = int(meta["start"]), int(meta["end"])
    frame_skip = int(meta.get("frame_skip", 1))
    video = decode_clip(path, start, end, frame_skip)
    video = pad_or_trim_video(video, seq_len)
    return resize_video_hw(video, out_hw)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def evaluate_test(model, dataset: FeatureClipDataset, batch_size: int = 16,
                  mesh=None, use_kernels: bool = True):
    """Full-test-set metrics: (loss, mpjpe_m, l3d, l2d=0) like the trainer's
    validation pass, on the model's device.

    One eval implementation for the whole package: this delegates to
    :func:`h36x_torch.train.loop.evaluate` with the weighted eval step
    (per-batch metric SUMS over real rows, drained once), so the dataset
    mean is exact even when the tail batch is short and there is no
    per-batch host sync. `use_kernels` as in the trainer's eval: the fused
    kernels on CUDA tensors, at precise=True (float32, as training and the
    model's own forward). With a `mesh` (h36x's), batches are padded to
    its data axis (weight 0) and their rows split over this process's
    local devices, the params placed on each device once
    (:class:`h36x_torch.parallel.local.Replicas`); a model axis inside the
    process splits the wide layers over its devices (a replica of the
    model carries the split, the model itself is left as it is)."""
    from h36x_torch.train.loop import evaluate

    replicas, pad_to = None, 1
    if mesh is not None:
        groups = mesh.local_groups()
        if len(groups[0]) > 1 and model.tp is None:
            model = replica_of(model, groups[0])
            shard_local(model, mesh, groups[0])
        replicas = Replicas(model, groups, grads=False)
        pad_to = data_axis_size(mesh)
    step = make_weighted_eval_step(model, use_kernels=use_kernels, replicas=replicas)
    sampler = SequentialBatchSampler(dataset, batch_size)
    metrics = evaluate(step, dataset, sampler, _device_of(model), torch.float32, pad_to)
    return metrics["loss"], metrics["mpjpe"], metrics["l3d"], 0.0


def dump_result_batch(
    model,
    dataset: FeatureClipDataset,
    preprocessed_root: str,
    out_path: str,
    seq_len: int,
    batch_size: int = 16,
    save_n: int = 16,
    video_size: Optional[int] = 224,
    test_metrics=(0.0, 0.0, 0.0, 0.0),
    forward_fn=None,
) -> dict:
    """Predict one batch and write the results NPZ; returns the payload.

    The default forward is the model's plain eval forward; forward_fn
    optionally overrides it with a feats -> joints engine over the model's
    params (e.g. h36x_torch.infer.make_fused_forward for the kernels'
    path)."""
    if not dataset.test_set:
        raise ValueError(
            "dump_result_batch needs clip meta (video lookup) — construct "
            "the FeatureClipDataset with test_set=True")
    idx = list(range(min(batch_size, len(dataset))))
    feats, j3d, j2d, K, meta = dataset.get_batch(idx)
    x = as_tensor(feats).to(_device_of(model)).float()
    if forward_fn is not None:
        pred = forward_fn(x)
    else:
        pred = make_forward(model, use_kernels=False)(x)
    pred = pred.cpu().numpy()

    if seq_len != feats.shape[1]:
        # videos must be cut to the STORE's T, or frame t in the NPZ stops
        # corresponding to joints[t]/pred[t] (and the viewers walk off the
        # end) whenever the --seq-len flag disagrees with the store
        print(f"WARNING: requested seq_len {seq_len} != store rows' T "
              f"{feats.shape[1]}; using the store's")
        seq_len = int(feats.shape[1])

    b = min(len(idx), save_n)
    videos = []
    metas = []
    for i in range(b):
        if not isinstance(meta[i], dict):
            raise RuntimeError(f"meta[{i}] is {type(meta[i])}, expected dict")
        videos.append(
            load_video_clip_from_meta(preprocessed_root, meta[i], seq_len, video_size)
        )
        metas.append(meta[i])
    videos_np = np.stack(videos)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    payload = {
        "video": videos_np,
        "joints3d": j3d[:b],
        "predicted3djoints": pred[:b],
        "joints2d": j2d[:b],
        "K": K[:b],
        "meta": np.array(metas, dtype=object),
        "test_metrics": np.array(test_metrics, dtype=np.float32),
    }
    np.savez_compressed(out_path, **payload)
    return payload


def dump_debug_batch(
    dataset: FeatureClipDataset, out_path: str, batch_size: int = 8
) -> dict:
    """One feature batch -> debug NPZ, under the reference's field names
    (the video slot holds the features — the feature dataset has no
    pixels)."""
    if not dataset.test_set:
        raise ValueError(
            "dump_debug_batch saves clip meta — construct the "
            "FeatureClipDataset with test_set=True")
    idx = list(range(min(batch_size, len(dataset))))
    feats, j3d, j2d, K, meta = dataset.get_batch(idx)
    if feats.dtype == BF16_BITS:  # numpy has no bfloat16: the NPZ holds float32
        feats = as_tensor(feats).float().numpy()
    payload = {
        "video": feats,
        "joints3d": j3d,
        "joints2d": j2d,
        "cam_K": K,
        "meta": np.array(meta, dtype=object),
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez_compressed(out_path, **payload)
    return payload
