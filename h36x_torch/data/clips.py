"""Clip index + video decode over the ingested H36M layout (counterpart
of h36x/data/clips.py).

Layout: S{subject}/{Action}_{trial}/cam_{c}/ holding gt_poses.pkl,
camera_wext.pkl and one mp4. n_frames_sub = ceil(n_frames / frame_skip)
subsampled frames per video, windowed into clips of seq_len at the given
stride. Decoding uses OpenCV, imported only inside the decode functions, so
the port imports without it; a host without cv2 extracts from a source
that brings its own frames. :class:`PreprocessedClips` is the reference's
clip dataset API over the same index.
"""

from __future__ import annotations

import glob
import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class ClipIndex:
    video_path: str
    gt_path: str
    subject: int
    action: str
    cam: str
    cam_params: dict
    start: int  # in subsampled-frame units
    end: int  # exclusive
    video_idx: int = 0


def load_gt_poses(gt_path: str):
    with open(gt_path, "rb") as f:
        data = pickle.load(f)
    j3d = np.asarray(data["3d"], dtype=np.float32)
    j2d = np.asarray(data["2d"], dtype=np.float32)
    return j3d, j2d


def load_camera_params(cam_path: str) -> dict:
    with open(cam_path, "rb") as f:
        return pickle.load(f)


def scan_clips(
    root: str,
    subjects: List[int],
    seq_len: int = 40,
    stride: int = 10,
    frame_skip: int = 2,
    cams: Optional[List[int]] = None,
    max_clips: Optional[int] = None,
):
    """Walk the ingested tree and window every camera video into clips.

    Returns (clips, gt_cache, cam_cache): the caches map paths to loaded
    pose arrays / camera dicts so __getitem__ never re-reads pickles.
    """
    clips: List[ClipIndex] = []
    gt_cache: Dict[str, tuple] = {}
    cam_cache: Dict[str, dict] = {}
    video_counter = 0

    def full() -> bool:
        return max_clips is not None and len(clips) >= max_clips

    for s in subjects:
        subj_dir = os.path.join(root, f"S{s}")
        if not os.path.isdir(subj_dir):
            continue
        for action in sorted(
            a for a in os.listdir(subj_dir) if os.path.isdir(os.path.join(subj_dir, a))
        ):
            for cam_dir in sorted(glob.glob(os.path.join(subj_dir, action, "cam_*"))):
                cam_name = os.path.basename(cam_dir)
                cam_id = int(cam_name.replace("cam_", ""))
                if cams is not None and cam_id not in cams:
                    continue
                mp4s = sorted(glob.glob(os.path.join(cam_dir, "*.mp4")))
                gt_path = os.path.join(cam_dir, "gt_poses.pkl")
                cam_path = os.path.join(cam_dir, "camera_wext.pkl")
                if not mp4s or not os.path.isfile(gt_path) or not os.path.isfile(cam_path):
                    continue

                if gt_path not in gt_cache:
                    gt_cache[gt_path] = load_gt_poses(gt_path)
                n_frames = gt_cache[gt_path][0].shape[0]
                n_sub = (n_frames + frame_skip - 1) // frame_skip

                if cam_path not in cam_cache:
                    cam_cache[cam_path] = load_camera_params(cam_path)

                for start in range(0, n_sub - seq_len + 1, stride):
                    clips.append(
                        ClipIndex(
                            video_path=mp4s[0],
                            gt_path=gt_path,
                            subject=s,
                            action=action,
                            cam=cam_name,
                            cam_params=cam_cache[cam_path],
                            start=start,
                            end=start + seq_len,
                            video_idx=video_counter,
                        )
                    )
                    if full():
                        break
                video_counter += 1
                if full():
                    break
            if full():
                break
        if full():
            break

    if not clips:
        raise RuntimeError(f"no clips found under root={root} for subjects={subjects}")
    return clips, gt_cache, cam_cache


def decode_clip(
    video_path: str, start: int, end: int, frame_skip: int = 2
) -> np.ndarray:
    """Decode frames [start, end) in subsampled units as uint8 RGB (T,H,W,3).

    Fast path seeks to start*frame_skip and keeps every frame_skip-th frame;
    if seeking under-delivers (keyframe-sparse videos), falls back to a
    sequential scan from frame 0.
    """
    try:
        return _decode_seek(video_path, start, end, frame_skip)
    except FileNotFoundError:
        raise  # unopenable file: a second (scan) open cannot help
    except RuntimeError:
        return _decode_scan(video_path, start, end, frame_skip)


def _decode_seek(video_path: str, start: int, end: int, frame_skip: int) -> np.ndarray:
    import cv2

    target = end - start
    cap = cv2.VideoCapture(video_path)
    try:
        if not cap.isOpened():
            # FileNotFoundError (not RuntimeError) so decode_clip does NOT
            # retry via the sequential scan: reopening an unopenable file
            # doubles the latency and masks the real error
            raise FileNotFoundError(f"cannot open video {video_path}")
        cap.set(cv2.CAP_PROP_POS_FRAMES, start * frame_skip)
        # cv2 seeks are not always frame-accurate (B-frame/open-GOP H.264):
        # some builds land a few frames off and then deliver the right
        # NUMBER of frames from the wrong offset, which the count check
        # below cannot catch. The readback detects the gross failures;
        # RuntimeError routes decode_clip to the exact sequential scan.
        pos = cap.get(cv2.CAP_PROP_POS_FRAMES)
        if pos >= 0 and int(pos) != start * frame_skip:
            raise RuntimeError(
                f"inaccurate seek in {video_path}: asked for frame "
                f"{start * frame_skip}, positioned at {int(pos)}"
            )
        frames = []
        frame_idx = 0
        while len(frames) < target:
            ok, img = cap.read()
            if not ok:
                break
            if frame_idx % frame_skip == 0:
                frames.append(img[:, :, ::-1])  # BGR -> RGB
            frame_idx += 1
            if frame_idx > target * frame_skip * 2:
                break
        if len(frames) < target:
            raise RuntimeError(
                f"frame count mismatch reading {video_path}: got {len(frames)}, "
                f"expected {target} for slice [{start}:{end}] (skip={frame_skip})"
            )
        return np.ascontiguousarray(np.stack(frames[:target]))
    finally:
        cap.release()


def _decode_scan(video_path: str, start: int, end: int, frame_skip: int) -> np.ndarray:
    """Sequential full-scan decode keeping subsampled frames [start, end)."""
    import cv2

    target = end - start
    first_orig = start * frame_skip
    cap = cv2.VideoCapture(video_path)
    try:
        if not cap.isOpened():
            raise RuntimeError(f"cannot open video {video_path}")
        frames = []
        frame_idx = 0
        while len(frames) < target:
            ok, img = cap.read()
            if not ok:
                break
            if frame_idx >= first_orig and (frame_idx % frame_skip == 0):
                frames.append(img[:, :, ::-1])
            frame_idx += 1
        if len(frames) < target:
            raise RuntimeError(
                f"frame count mismatch scanning {video_path}: got {len(frames)}, "
                f"expected {target} for slice [{start}:{end}] (skip={frame_skip})"
            )
        return np.ascontiguousarray(np.stack(frames[:target]))
    finally:
        cap.release()


class PreprocessedClips:
    """The reference's clip dataset API (its Human36MPreprocessedClips).

    Items are preprocessed host arrays, channels-last:
      augment=False -> (video (T,o,o,3) f32 ImageNet-normalized,
                        joints3d (T,17,3), joints2d (T,17,2) cropped px,
                        K (3,3) adjusted, box (4,))
      augment=True  -> a list of the 4 variants [(video, j3d, j2d, K), ...]
                       in the order (orig, cjitter, hflip, trev).

    The extraction pipeline does not use this class (it keeps pixels u8);
    it is the convenience API for users coming from the reference.
    """

    def __init__(self, root: str, subjects: List[int], seq_len: int = 40,
                 stride: int = 10, frame_skip: int = 2,
                 cams: Optional[List[int]] = None, resize: int = 224,
                 crop_scale: float = 1.6, max_clips: Optional[int] = None,
                 augment: bool = False, jitter_seed: int = 0):
        self._ds = ClipDataset(root, subjects, seq_len, stride, frame_skip,
                               cams, max_clips)
        self.resize = resize
        self.crop_scale = crop_scale
        self.augment = augment
        self.jitter_seed = jitter_seed

    def __len__(self):
        return len(self._ds)

    @property
    def clips(self):
        return self._ds.clips

    def __getitem__(self, idx: int):
        from h36x_torch.data.augment import color_jitter_host, hflip_joints, reverse_joints
        from h36x_torch.extract.staging import crop_resize_host
        from h36x_torch.geometry.camera import adjust_camera_after_crop_and_resize
        from h36x_torch.geometry.crop import adjust_joints2d_after_crop_and_resize
        from h36x_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

        frames, j3d, j2d_raw, cam, _ci = self._ds[idx]
        small, box = crop_resize_host(frames, j2d_raw, self.resize,
                                      crop_scale=self.crop_scale)
        j2d = adjust_joints2d_after_crop_and_resize(j2d_raw, box, self.resize)
        K = adjust_camera_after_crop_and_resize(cam["f"], cam["c"], box, self.resize)

        video01 = small.astype(np.float32) / 255.0

        def norm(v):
            return (v - IMAGENET_MEAN) / IMAGENET_STD

        if not self.augment:
            return norm(video01), j3d, j2d, K, np.asarray(box)

        rng = np.random.default_rng(self.jitter_seed * 1_000_003 + idx)
        cj = color_jitter_host(video01, rng)
        j3d_hf, j2d_hf, K_hf = hflip_joints(j3d, j2d, K, width=self.resize)
        j3d_tr, j2d_tr = reverse_joints(j3d, j2d)
        return [
            (norm(video01), j3d, j2d, K),
            (norm(cj), j3d, j2d, K),
            (norm(video01[:, :, ::-1, :]), j3d_hf, j2d_hf, K_hf),
            (norm(video01[::-1]), j3d_tr, j2d_tr, K),
        ]


class SequentialVideoCursor:
    """One sequential decode pass over a video serving monotonic clip windows.

    Consecutive clips of a video overlap by seq_len - stride subsampled
    frames (stride=5, seq_len=40 -> 35 of 40 shared); the legacy per-clip
    `decode_clip` seeks and re-decodes every window, paying up to 8x
    redundant decode work. This cursor reads the file ONCE front to back
    (cv2 sequential read, no seeks) and keeps a ring of the subsampled
    frames still inside any future window. `get(start, end)` calls must
    have non-decreasing `start` — exactly the order clip windows are
    scheduled in.
    """

    def __init__(self, video_path: str, frame_skip: int = 2):
        import cv2

        self.path = video_path
        self.frame_skip = frame_skip
        self._cap = cv2.VideoCapture(video_path)
        if not self._cap.isOpened():
            self._cap.release()
            raise FileNotFoundError(f"cannot open video {video_path}")
        self._raw_idx = 0  # next raw frame the capture will deliver
        self._buf: Dict[int, np.ndarray] = {}  # subsampled idx -> RGB frame
        self._min_start = 0

    def get(self, start: int, end: int) -> np.ndarray:
        """Subsampled frames [start, end) as (T, H, W, 3) u8 RGB."""
        if start < self._min_start:
            raise ValueError(
                f"non-monotonic cursor access: start={start} after "
                f"start={self._min_start} on {self.path}"
            )
        self._min_start = start
        for idx in [i for i in self._buf if i < start]:
            del self._buf[idx]
        while (end - 1) not in self._buf:
            ok, img = self._cap.read()
            if not ok:
                raise RuntimeError(
                    f"frame count mismatch scanning {self.path}: ran out at "
                    f"raw frame {self._raw_idx}, need subsampled [{start}:{end}] "
                    f"(skip={self.frame_skip})"
                )
            if self._raw_idx % self.frame_skip == 0:
                sub = self._raw_idx // self.frame_skip
                if sub >= start:
                    self._buf[sub] = np.ascontiguousarray(img[:, :, ::-1])
            self._raw_idx += 1
        try:
            return np.stack([self._buf[i] for i in range(start, end)])
        except KeyError as e:
            raise RuntimeError(
                f"missing subsampled frame {e} decoding {self.path} "
                f"[{start}:{end}]"
            )

    def close(self) -> None:
        self._cap.release()
        self._buf.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ClipDataset:
    """Indexable clip provider: decoded frames + windowed poses + camera.

    Item: (frames_u8 (T,H,W,3), joints3d (T,17,3), joints2d (T,17,2),
           cam_params dict, clip: ClipIndex).
    Geometry (crop box / K adjustment) is left to the consumer so the
    extraction pipeline can fuse crop+resize on device.

    Beyond the indexable API, the dedup extraction scheduler
    (h36x_torch/extract/dedup.py) uses the video-structured access surface:
    :meth:`video_groups`, :meth:`clip_annotations` (no decode) and
    :meth:`open_video` (one sequential decode pass per video).
    """

    def __init__(
        self,
        root: str,
        subjects: List[int],
        seq_len: int = 40,
        stride: int = 10,
        frame_skip: int = 2,
        cams: Optional[List[int]] = None,
        max_clips: Optional[int] = None,
    ):
        self.seq_len = seq_len
        self.frame_skip = frame_skip
        self.clips, self._gt_cache, self._cam_cache = scan_clips(
            root, subjects, seq_len, stride, frame_skip, cams, max_clips
        )
        # video_idx -> any clip of that video: the dedup scheduler calls
        # open_video/video_joints2d once per video, and a linear scan of
        # the full clip list per call is O(n_videos * n_clips) on a real
        # extraction (~840 videos x ~100k clips)
        self._video_clip: Dict[int, ClipIndex] = {}
        for ci in self.clips:
            self._video_clip.setdefault(ci.video_idx, ci)

    def __len__(self):
        return len(self.clips)

    def video_groups(self) -> List[List[int]]:
        """Global clip indices grouped by video, clips in start order.

        Videos appear in scan order and clips within a video are generated
        with increasing start (scan_clips windowing loop), so iterating
        groups and clips in this order visits clips in global-index order —
        the invariant the dedup scheduler's in-order assembly relies on.
        """
        groups: Dict[int, List[int]] = {}
        for i, ci in enumerate(self.clips):
            groups.setdefault(ci.video_idx, []).append(i)
        return [groups[v] for v in sorted(groups)]

    def clip_annotations(self, idx: int):
        """(joints3d, joints2d, cam_params, ci) for a clip — no decode."""
        ci = self.clips[idx]
        j3d_all, j2d_all = self._gt_cache[ci.gt_path]
        orig_idx = np.arange(ci.start, ci.end) * self.frame_skip
        if orig_idx[-1] >= j3d_all.shape[0]:
            raise RuntimeError(
                f"joint index out of range for {ci.gt_path}: "
                f"max={orig_idx[-1]}, n_frames={j3d_all.shape[0]}"
            )
        return j3d_all[orig_idx], j2d_all[orig_idx], ci.cam_params, ci

    def video_joints2d(self, video_idx: int) -> np.ndarray:
        """All subsampled-frame 2D joints of a video (crop_scope='video')."""
        ci = self._video_clip.get(video_idx)
        if ci is None:
            raise KeyError(f"no clips for video_idx={video_idx}")
        return self._gt_cache[ci.gt_path][1][:: self.frame_skip]

    def open_video(self, video_idx: int) -> SequentialVideoCursor:
        """Sequential decode cursor for one video (dedup extraction path)."""
        ci = self._video_clip.get(video_idx)
        if ci is None:
            raise KeyError(f"no clips for video_idx={video_idx}")
        return SequentialVideoCursor(ci.video_path, self.frame_skip)

    def __getitem__(self, idx: int):
        ci = self.clips[idx]
        frames = decode_clip(ci.video_path, ci.start, ci.end, self.frame_skip)
        j3d_all, j2d_all = self._gt_cache[ci.gt_path]
        orig_idx = np.arange(ci.start, ci.end) * self.frame_skip
        if orig_idx[-1] >= j3d_all.shape[0]:
            raise RuntimeError(
                f"joint index out of range for {ci.gt_path}: "
                f"max={orig_idx[-1]}, n_frames={j3d_all.shape[0]}"
            )
        joints3d = j3d_all[orig_idx]
        joints2d = j2d_all[orig_idx]
        if frames.shape[0] != joints3d.shape[0]:
            raise RuntimeError(
                f"T mismatch: video {frames.shape[0]} vs joints {joints3d.shape[0]}"
            )
        return frames, joints3d, joints2d, ci.cam_params, ci
