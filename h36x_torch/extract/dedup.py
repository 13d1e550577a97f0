"""Unique-frame extraction scheduling (counterpart of h36x/extract/dedup.py):
compute each overlapping frame once.

At stride 5 and seq_len 40 every subsampled frame belongs to up to 8
clips; the per-clip pipeline decodes and runs the backbone on it once per
clip. This scheduler works per unique frame instead:

- **decode**: one sequential pass per video (SequentialVideoCursor);
- **crop**: the crop box is computed from the clip's whole 2D-joint
  window, so the caches are content-addressed by (frame_idx, box): the
  store matches the per-clip pipeline's byte for byte at any box
  stability, and every repeated (frame, box) pair is paid once;
- **backbone**: per (frame, box) the deterministic variants (orig, hflip)
  are computed once; temporal-reverse is the orig features reversed. The
  color-jitter pass is per-clip keyed under jitter_key='clip' (reference
  parity, not dedupable); jitter_key='video'|'frame' re-keys it per video
  or frame, which makes it dedupable too;
- **crop_scope='video'**: one box per video, from all its subsampled
  frames' joints, which guarantees the full seq_len/stride dedup at the
  cost of a looser crop. crop_scope='video' with jitter_key='video' is the
  production profile ('auto').

Steady-state device cost per clip of T frames at stride s (stable boxes):
  per-clip pipeline:                    3T   (=120)  backbone-frames
  dedup, jitter_key='clip':             T+2s (= 50)
  dedup, jitter_key='video'/'frame':    3s   (= 15)
  (without augment: T per clip, s under dedup)

A dispatch carries, by default, the rows that `batch_size` clips add in
steady state under the call's resolved profile (the counts above times
`batch_size`): it goes as soon as that many rows are pending, and the
last one goes at its own size, with no zero rows on one device. The
sizes follow the row count alone, so a store repeats bit for bit. The
store contract, row order (clips enter the shuffle pool in global
clip-index order), per-clip jitter rng and resume/partition semantics are
those of the per-clip pipeline. On one device an hflip row is staged as
its crop and mirrored by the device after the copy (the dispatch sends
such rows last); over a mesh the host mirrors it. On the card, the
features of a dispatch stay on the device until the next dispatch has
been queued and the host finalizes this one.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from h36x_torch.config import ExtractConfig
from h36x_torch.data.augment import jitter_u8, sample_jitter_params
from h36x_torch.extract.staging import DeviceFeatures, crop_resize_frames, rows_to_device
from h36x_torch.geometry.crop import compute_square_crop_from_2d
from h36x_torch.utils.profiling import count, span

# (subsampled frame index, (top, left, side)) — the content address of a crop
FrameKey = Tuple[int, Tuple[int, int, int]]


class _ConsumerGone(Exception):
    """Raised inside a worker when the consumer has stopped listening."""


@dataclass
class ClipJob:
    """One clip's schedule: which cached features it needs and which unique
    frames it is responsible for computing (first-seen within its video)."""

    index: int  # global clip index
    video_idx: int
    ci: object  # ClipIndex-like metadata
    j3d: np.ndarray
    j2d_raw: np.ndarray
    cam: dict
    box: np.ndarray  # (4,)
    window_keys: List[FrameKey]  # seq_len keys, in time order
    # first-seen (key, crop u8 (o,o,3)) pairs this job must compute: the
    # rows of its crop output
    miss: List[Tuple[FrameKey, np.ndarray]] = field(default_factory=list)
    # first-seen jittered crops (jitter_key='video'|'frame')
    cj_miss: List[Tuple[FrameKey, np.ndarray]] = field(default_factory=list)
    # per-clip jittered window (jitter_key='clip'), filled in order
    cj_window: Optional[np.ndarray] = None  # (T,o,o,3) u8
    cj_feats: Optional[list] = None  # len-T list of rows, set at dispatch

    @property
    def nbytes(self) -> int:
        """The crop bytes the job carries to the consumer."""
        rows = sum(c.nbytes for _, c in self.miss) + sum(
            c.nbytes for _, c in self.cj_miss)
        return rows + (self.cj_window.nbytes if self.cj_window is not None else 0)


# jobs the worker of the video being consumed may hold queued
CURRENT_DEPTH = 8


def default_frames_per_dispatch(cfg: ExtractConfig) -> int:
    """The rows `batch_size` clips add to the backbone's work in steady
    state under `cfg`'s resolved profile: stride new frames a clip in each
    pixel variant, and under jitter_key='clip' the clip's whole jittered
    window besides."""
    if not cfg.augment:
        return cfg.batch_size * cfg.stride
    if cfg.jitter_key == "clip":
        return cfg.batch_size * (cfg.seq_len + 2 * cfg.stride)
    return cfg.batch_size * cfg.stride * 3


def _feed_budget(cfg: ExtractConfig, frames_per_dispatch: int) -> int:
    """Bytes the workers of the videos after the consumer's may hold
    queued: a per-clip batch of crop rows (batch_size * seq_len * pixel
    variants), or one dispatch of them if that is larger."""
    rows = max(cfg.batch_size * cfg.seq_len * (3 if cfg.augment else 1),
               frames_per_dispatch)
    return rows * cfg.resize * cfg.resize * 3


class _Feed:
    """The video workers' jobs, handed to the consumer video by video and,
    within a video, in the order they were put.

    The worker of the video being consumed (`current`, a position in the
    video order) may hold up to CURRENT_DEPTH jobs queued and never waits
    on other videos. The workers of every later video share `budget`
    bytes: a job of theirs waits while the bytes queued for later videos
    and its own would pass it, unless none are queued, so a budget smaller
    than one job still moves. "done" and "error" never wait. Once the
    consumer calls `close()`, every put wakes and raises _ConsumerGone.
    """

    def __init__(self, n_videos: int, budget: int):
        self.budget = budget
        self.queues = [deque() for _ in range(n_videos)]  # (item, nbytes)
        self.queued = [0] * n_videos  # bytes queued per video
        self.current = 0
        self.ahead = 0  # bytes queued for the videos after `current`
        self.closed = False
        self.cond = threading.Condition()

    def _room(self, pos: int, kind: str, nbytes: int) -> bool:
        if kind != "job":
            return True
        if pos == self.current:
            return len(self.queues[pos]) < CURRENT_DEPTH
        return not self.ahead or self.ahead + nbytes <= self.budget

    def put(self, pos: int, item: tuple) -> None:
        """Queue a worker's ("job", job), ("done", None) or ("error", e)."""
        nbytes = item[1].nbytes if item[0] == "job" else 0
        with self.cond:
            while True:
                if self.closed:
                    raise _ConsumerGone()
                if self._room(pos, item[0], nbytes):
                    break
                self.cond.wait()
            self.queues[pos].append((item, nbytes))
            self.queued[pos] += nbytes
            if pos > self.current:
                self.ahead += nbytes
            self.cond.notify_all()

    def get(self) -> Tuple[tuple, bool]:
        """The current video's next item, and whether it was already queued."""
        with self.cond:
            queue = self.queues[self.current]
            ready = bool(queue)
            while not queue:
                self.cond.wait()
            item, nbytes = queue.popleft()
            self.queued[self.current] -= nbytes
            self.cond.notify_all()
        return item, ready

    def advance(self) -> None:
        """Move to the next video, once the current one's "done" was taken:
        its queued bytes leave the shared budget."""
        with self.cond:
            self.current += 1
            if self.current < len(self.queues):
                self.ahead -= self.queued[self.current]
            self.cond.notify_all()

    def close(self) -> None:
        with self.cond:
            self.closed = True
            self.cond.notify_all()


def _frame_jitter_rng(seed: int, video_idx: int, frame_idx: int):
    return np.random.default_rng(
        seed * 3_000_017 + video_idx * 1_000_003 + frame_idx
    )


def _video_jitter_rng(seed: int, video_idx: int):
    return np.random.default_rng(seed * 2_000_003 + video_idx)


def _video_worker(
    dataset,
    group: List[int],
    todo_set,
    cfg: ExtractConfig,
    feed: _Feed,
    pos: int,
) -> None:
    """Process one video's clips in start order; emit ClipJobs into `feed`
    as the video at position `pos` of the consumer's order.

    Owns the sequential decode cursor and the host-side crop cache; the
    first-seen bookkeeping here is independent of device batching, so the
    set of computed unique frames is deterministic for a given todo set.
    A put waits while the feed has no room for the job; when the consumer
    dies, `feed.close()` aborts the worker, so that the executor's
    shutdown cannot hang on it.
    """
    def put(item):
        with span("h36x.extract.put_wait"):
            feed.put(pos, item)

    cursor = None
    try:
        todo = [i for i in group if i in todo_set]
        if not todo:
            put(("done", None))
            return
        video_idx = dataset.clips[todo[0]].video_idx
        if hasattr(dataset, "open_video"):
            cursor = dataset.open_video(video_idx)
        crop_cache: Dict[FrameKey, np.ndarray] = {}
        video_box = None
        video_params = None
        if cfg.augment and cfg.jitter_key == "video":
            video_params = sample_jitter_params(
                _video_jitter_rng(cfg.shuffle_seed, video_idx)
            )

        for i in todo:
            with span("h36x.extract.job"):
                j3d, j2d_raw, cam, ci = dataset.clip_annotations(i)
                if cursor is not None:
                    frames = cursor.get(ci.start, ci.end)
                else:  # no sequential access: per-clip decode fallback
                    frames = dataset[i][0]
                t_len, img_h, img_w, _ = frames.shape

                if cfg.crop_scope == "video":
                    if video_box is None:
                        video_box = compute_square_crop_from_2d(
                            dataset.video_joints2d(video_idx), img_h, img_w,
                            scale=1.6,
                        )
                    box = video_box
                else:  # 'clip': the reference's per-clip box
                    box = compute_square_crop_from_2d(
                        j2d_raw, img_h, img_w, scale=1.6
                    )
                bkey = (int(box[0]), int(box[1]), int(box[2]))

                for k in [k for k in crop_cache if k[0] < ci.start]:
                    del crop_cache[k]

                # Every earlier clip started no later than this one and the
                # frames before ci.start left the cache, so the cached keys
                # of this box are a prefix of the window. The rest, from
                # `lo`, is one run of frames that no earlier job of the
                # video has seen: this job's first-seen keys.
                keys = [(ci.start + t, bkey) for t in range(t_len)]
                lo = sum(k in crop_cache for k in keys)
                assert all(k in crop_cache for k in keys[:lo]), (
                    f"clip {i}: the cached frames are not a prefix of its window")
                new_keys = keys[lo:]
                rows = ()
                if new_keys:
                    with span("h36x.extract.crop"):
                        rows = crop_resize_frames(frames[lo:], box, cfg.resize)
                    count("h36x.extract.frames_cropped", len(new_keys))
                    crop_cache.update(zip(new_keys, rows))

                # The rows of the crop's own output: it holds this job's
                # first-seen rows and no other, so a row the consumer keeps
                # queued pins nothing it does not need.
                job = ClipJob(
                    index=i, video_idx=video_idx, ci=ci, j3d=j3d,
                    j2d_raw=j2d_raw, cam=cam, box=np.asarray(box),
                    window_keys=keys, miss=list(zip(new_keys, rows)),
                )
                stacked = 0
                if cfg.augment:
                    if cfg.jitter_key == "clip":
                        rng = np.random.default_rng(
                            cfg.shuffle_seed * 1_000_003 + i
                        )
                        params = sample_jitter_params(rng)
                        window = np.stack([crop_cache[k] for k in keys])
                        stacked = len(window)
                        with span("h36x.extract.jitter"):
                            job.cj_window = jitter_u8(window, params)
                        count("h36x.extract.frames_jittered", len(window))
                    elif cfg.jitter_key == "video":
                        # one params set for the whole video: jitter every
                        # first-seen frame in ONE kernel call (per-frame calls
                        # pay a thread spawn/join each — pure waste in the mode
                        # built for maximum dedup throughput)
                        if new_keys:
                            with span("h36x.extract.jitter"):
                                cjs = jitter_u8(rows, video_params)
                            count("h36x.extract.frames_jittered", len(new_keys))
                            job.cj_miss = list(zip(new_keys, cjs))
                    else:  # jitter_key == "frame": distinct params per frame
                        for k, row in zip(new_keys, rows):
                            params = sample_jitter_params(
                                _frame_jitter_rng(cfg.shuffle_seed, video_idx,
                                                  k[0])
                            )
                            with span("h36x.extract.jitter"):
                                cj = jitter_u8(row[None], params)[0]
                            count("h36x.extract.frames_jittered")
                            job.cj_miss.append((k, cj))
                count("h36x.extract.rows_stacked", stacked)
            put(("job", job))
        put(("done", None))
    except _ConsumerGone:
        pass  # consumer already failed; nothing to report
    except BaseException as e:  # propagate to the consumer thread
        try:
            put(("error", e))
        except _ConsumerGone:
            pass
    finally:
        if cursor is not None:
            cursor.close()  # even on error paths: the cv2 capture holds an fd


class _Assembler:
    """In-order clip assembly over the per-video feature cache."""

    def __init__(self, cfg: ExtractConfig, add_clip):
        self.cfg = cfg
        self.add_clip = add_clip  # (ci, box, j3d, j2d_raw, cam, feats)
        self.fifo: deque = deque()
        # video_idx -> {(FrameKey, variant): feature row}
        self.cache: Dict[int, Dict[Tuple[FrameKey, str], np.ndarray]] = {}
        self.backbone_rows = 0  # real (unpadded) rows sent to the device

    def store(self, tag, row: np.ndarray) -> None:
        kind = tag[0]
        if kind == "cache":
            _, vid, key, var = tag
            self.cache.setdefault(vid, {})[(key, var)] = row
        else:  # ("job", job, t): per-clip jitter row
            _, job, t = tag
            job.cj_feats[t] = row

    def _ready(self, job: ClipJob) -> bool:
        cache = self.cache.get(job.video_idx, {})
        for k in job.window_keys:
            if (k, "o") not in cache:
                return False
            if self.cfg.augment and (k, "h") not in cache:
                return False
        if self.cfg.augment:
            if job.cj_feats is not None:  # per-clip-keyed jitter rows
                if any(r is None for r in job.cj_feats):
                    return False
            else:  # video/frame-keyed jitter: rows come from the cache
                for k in job.window_keys:
                    if (k, "c") not in cache:
                        return False
        return True

    def drain(self) -> None:
        while self.fifo and self._ready(self.fifo[0]):
            job = self.fifo.popleft()
            self._assemble(job)
            # Videos are processed in ascending video_idx (video_groups
            # order), so assembling a job of video v means every EARLIER
            # video is fully done; later videos may already have rows
            # cached from in-flight dispatches — keep those.
            for vid in [v for v in self.cache if v < job.video_idx]:
                del self.cache[vid]
            # Frames before this clip's start are out of every later window
            # (workers emit clips in start order).
            cache = self.cache.get(job.video_idx)
            if cache is not None:
                for ck in [ck for ck in cache if ck[0][0] < job.ci.start]:
                    del cache[ck]

    def _assemble(self, job: ClipJob) -> None:
        cache = self.cache[job.video_idx]
        feats = [np.stack([cache[(k, "o")] for k in job.window_keys])]
        if self.cfg.augment:
            if job.cj_feats is not None:  # per-clip-keyed jitter
                f_cj = np.stack(job.cj_feats)
            else:  # video/frame-keyed jitter: rows live in the cache
                f_cj = np.stack([cache[(k, "c")] for k in job.window_keys])
            feats += [f_cj, np.stack([cache[(k, "h")] for k in job.window_keys])]
        self.add_clip(job.ci, job.box, job.j3d, job.j2d_raw, job.cam, feats)


def run_unique_frames(cfg: ExtractConfig, dataset, groups: List[List[int]], todo,
                      store, feature_fn, mesh, device) -> int:
    """The unique-frame loop of one run: the clips in `todo` of the videos
    `groups`, through `feature_fn` (over `mesh` when there is one), into
    `store` (:class:`h36x_torch.extract.store.Store`). Returns the rows
    sent to the backbone."""
    todo_set = set(todo)
    assembler = _Assembler(cfg, store.add_clip)

    # --- device batching: a dispatch goes once `frames_per_dispatch` rows
    # are pending (by default what `batch_size` clips add), the last at its
    # own size
    frames_per_dispatch = (cfg.frames_per_dispatch
                           or default_frames_per_dispatch(cfg))
    if frames_per_dispatch < 1:
        # validate with the other dedup flags: a negative value would only
        # blow up as an opaque numpy negative-dimension error deep in the
        # hot loop, after the backbone load and worker startup
        raise ValueError(
            f"--frames-per-dispatch must be positive, got {frames_per_dispatch}")
    # (tag, crop u8 (o,o,3), mirrored): a mirrored row is its crop flipped
    # along the width
    pending: List[tuple] = []
    inflight = None
    # over a mesh the feature function pads a dispatch to a multiple of this
    replicas = mesh.shape["data"] if mesh else 1

    def dispatch(chunk):
        nonlocal inflight
        n = len(chunk)
        with span("h36x.extract.stage"):
            if not mesh:
                # the rows to mirror go last, each group in queue order; the
                # card mirrors them, and the tags follow their rows
                chunk = ([e for e in chunk if not e[2]]
                         + [e for e in chunk if e[2]])
                flipped = sum(e[2] for e in chunk)
                frames = rows_to_device([c for _, c, _ in chunk], n, device,
                                        flip=flipped)
            else:
                # over a mesh each device's block goes to it from the host
                flipped = 0
                frames = np.stack([c[:, ::-1] if m else c for _, c, m in chunk])
        count("h36x.extract.dispatches")
        count("h36x.extract.pad_rows", -n % replicas)
        count("h36x.extract.rows_flipped", flipped)
        with span("h36x.extract.feature_fn"):
            feats_dev = DeviceFeatures(feature_fn(frames))
        assembler.backbone_rows += n
        new = (feats_dev, [t for t, _, _ in chunk])
        if inflight is not None:
            finalize(inflight)
        inflight = new

    def finalize(batch):
        feats_dev, tags = batch
        with span("h36x.extract.drain"):
            feats = feats_dev.numpy(store.feat_dtype)
            for tag, row in zip(tags, feats):
                assembler.store(tag, row)
            assembler.drain()

    def enqueue(job: ClipJob):
        for k, crop in job.miss:
            pending.append((("cache", job.video_idx, k, "o"), crop, False))
            if cfg.augment:  # the hflip row: its crop, mirrored at dispatch
                pending.append((("cache", job.video_idx, k, "h"), crop, True))
        for k, cj in job.cj_miss:
            pending.append((("cache", job.video_idx, k, "c"), cj, False))
        if job.cj_window is not None:
            t_len = job.cj_window.shape[0]
            job.cj_feats = [None] * t_len
            for t in range(t_len):
                pending.append((("job", job, t), job.cj_window[t], False))
            job.cj_window = None  # crops live in `pending` now; free the ref
        # clear the miss lists too: jobs can sit in the fifo for many
        # dispatches awaiting rows — `pending` owns the frames from here
        # (miss rows are the rows of the worker's crop output, which holds
        # no others, so dropping the job-side refs frees memory as pending
        # drains)
        job.miss = []
        job.cj_miss = []
        assembler.fifo.append(job)
        while len(pending) >= frames_per_dispatch:
            dispatch(pending[:frames_per_dispatch])
            del pending[:frames_per_dispatch]

    # --- run the per-video workers, every later video cropping ahead under
    # one byte budget, consuming jobs strictly in video order = global
    # clip order
    feed = _Feed(len(groups), _feed_budget(cfg, frames_per_dispatch))
    futures = []  # bound before try: the except block iterates it even
    # when the submit comprehension itself is what raised
    with ThreadPoolExecutor(max_workers=max(1, cfg.num_workers)) as ex:
        try:
            futures = [
                ex.submit(_video_worker, dataset, g, todo_set, cfg, feed, pos)
                for pos, g in enumerate(groups)
            ]
            for _ in groups:
                while True:
                    with span("h36x.extract.wait_jobs"):
                        (kind, payload), ready = feed.get()
                    if kind == "error":
                        raise payload
                    if kind == "done":
                        feed.advance()
                        break
                    if ready:
                        count("h36x.extract.jobs_ready")
                    enqueue(payload)
            if pending:  # fewer than frames_per_dispatch: at their own size
                dispatch(pending)
            if inflight is not None:
                finalize(inflight)
        except BaseException:
            # unblock every worker waiting for room so the executor's
            # shutdown join cannot hang
            feed.close()
            for f in futures:
                f.cancel()
            raise

    if assembler.fifo:
        raise RuntimeError(
            f"{len(assembler.fifo)} clips left unassembled — dedup "
            "scheduler bookkeeping bug"
        )

    return assembler.backbone_rows
