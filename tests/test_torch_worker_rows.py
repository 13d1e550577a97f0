"""The rows a video worker of h36x_torch's unique-frame scheduler
(extract/dedup.py's `_video_worker`) hands to the consumer, on the CPU:
every job's keys, first-seen rows and jittered rows equal, byte for byte,
those of a worker that gathers the new raw frames, stacks the clip's whole
window of crops and copies each first-seen row out of it; a first-seen row
pins no more than the job's own new rows; and `h36x.extract.rows_stacked`
counts the crop rows copied into a clip window, only under
jitter_key='clip'."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

from h36x_torch.config import ExtractConfig
from h36x_torch.data.augment import jitter_u8, sample_jitter_params
from h36x_torch.extract import dedup
from h36x_torch.extract.staging import crop_resize_frames
from h36x_torch.geometry.crop import compute_square_crop_from_2d
from h36x_torch.utils import profiling

H, W = 40, 48
SEQ_LEN, STRIDE, N_SUB = 6, 2, 30
# frames of video 1 whose joints move: a clip-scope box changes mid-video
MOVED = range(10, 16)
PROFILES = [(scope, key) for scope in ("video", "clip") for key in ("video", "frame", "clip")]
JOIN_S = 30.0


class _Videos:
    """Two videos of seeded frames, clips of SEQ_LEN at STRIDE in start
    order. `cursor=True` serves a clip's frames as a view of its video's
    array, as the benchmark's synthetic videos do; otherwise the worker
    takes its per-clip fallback, `self[i][0]`, a fresh array."""

    def __init__(self, cursor: bool):
        self.cursor = cursor
        self.frames, self.j2d, self.clips = [], [], []
        for v in range(2):
            rng = np.random.default_rng(7 + v)
            self.frames.append(rng.integers(0, 256, (N_SUB, H, W, 3), dtype=np.uint8))
            j2d = np.repeat(rng.random((1, 17, 2)) * [W / 2, H / 2] + [W / 4, H / 4],
                            N_SUB, axis=0).astype(np.float32)
            if v == 1:
                j2d[MOVED.start:MOVED.stop] += [6.0, 3.0]
            self.j2d.append(j2d)
            for start in range(0, N_SUB - SEQ_LEN + 1, STRIDE):
                self.clips.append(SimpleNamespace(start=start, end=start + SEQ_LEN,
                                                  video_idx=v))

    def video_groups(self):
        return [[i for i, c in enumerate(self.clips) if c.video_idx == v] for v in range(2)]

    def video_joints2d(self, video_idx):
        return self.j2d[video_idx]

    def clip_annotations(self, i):
        ci = self.clips[i]
        j2d = self.j2d[ci.video_idx][ci.start:ci.end].copy()
        return np.zeros((SEQ_LEN, 17, 3), np.float32), j2d, {}, ci

    def __getitem__(self, i):
        ci = self.clips[i]
        return (self.frames[ci.video_idx][ci.start:ci.end].copy(),)

    def __getattr__(self, name):
        if name == "open_video" and self.cursor:
            return lambda v: SimpleNamespace(get=lambda s, e: self.frames[v][s:e],
                                             close=lambda: None)
        raise AttributeError(name)


def _cfg(crop_scope, jitter_key, augment=True):
    return ExtractConfig(out="unused", seq_len=SEQ_LEN, stride=STRIDE, resize=16,
                         augment=augment, shuffle_seed=3, crop_scope=crop_scope,
                         jitter_key=jitter_key)


def _worker_jobs(ds, cfg, video):
    """The jobs `_video_worker` puts for `video`, in order."""
    group = ds.video_groups()[video]
    feed = dedup._Feed(1, budget=1 << 40)
    thread = threading.Thread(target=dedup._video_worker,
                              args=(ds, group, set(group), cfg, feed, 0), daemon=True)
    thread.start()
    jobs = []
    while True:
        (kind, payload), _ = feed.get()
        if kind == "error":
            raise payload
        if kind == "done":
            break
        jobs.append(payload)
    thread.join(JOIN_S)
    assert not thread.is_alive()
    return jobs


def _gathered_jobs(ds, cfg, video):
    """Each job's rows built as a worker that gathers, stacks and copies
    builds them: the new raw frames gathered by index and cropped, the
    clip's whole window stacked from the crop cache, each first-seen row
    copied out of it and each first-seen jittered row taken from it."""
    group = ds.video_groups()[video]
    crop_cache, seen, seen_cj, out = {}, set(), set(), []
    video_params = sample_jitter_params(dedup._video_jitter_rng(cfg.shuffle_seed, video))
    for i in group:
        _, j2d, _, ci = ds.clip_annotations(i)
        frames = ds.frames[video][ci.start:ci.end]
        t_len = frames.shape[0]
        joints = ds.video_joints2d(video) if cfg.crop_scope == "video" else j2d
        box = compute_square_crop_from_2d(joints, H, W, scale=1.6)
        bkey = (int(box[0]), int(box[1]), int(box[2]))
        for k in [k for k in crop_cache if k[0] < ci.start]:
            del crop_cache[k]
        keys = [(ci.start + t, bkey) for t in range(t_len)]
        new_t = [t for t in range(t_len) if keys[t] not in crop_cache]
        if new_t:
            cropped = crop_resize_frames(frames[new_t], box, cfg.resize)
            for j, t in enumerate(new_t):
                crop_cache[keys[t]] = cropped[j]
        window = np.stack([crop_cache[k] for k in keys])
        job = SimpleNamespace(keys=keys, miss=[], cj_miss=[], cj_window=None)
        for t, k in enumerate(keys):
            if k not in seen:
                seen.add(k)
                job.miss.append((k, window[t].copy()))
        if cfg.augment and cfg.jitter_key == "clip":
            rng = np.random.default_rng(cfg.shuffle_seed * 1_000_003 + i)
            job.cj_window = jitter_u8(window, sample_jitter_params(rng))
        elif cfg.augment and cfg.jitter_key == "video":
            new_ts = [t for t, k in enumerate(keys) if k not in seen_cj]
            if new_ts:
                cjs = jitter_u8(window[new_ts], video_params)
                for j, t in enumerate(new_ts):
                    seen_cj.add(keys[t])
                    job.cj_miss.append((keys[t], cjs[j]))
        elif cfg.augment:
            for t, k in enumerate(keys):
                if k not in seen_cj:
                    seen_cj.add(k)
                    params = sample_jitter_params(
                        dedup._frame_jitter_rng(cfg.shuffle_seed, video, k[0]))
                    job.cj_miss.append((k, jitter_u8(window[t:t + 1], params)[0]))
        out.append(job)
    return out


def _assert_rows_equal(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("cursor", [True, False], ids=["cursor", "per_clip_decode"])
@pytest.mark.parametrize("video", [0, 1], ids=["still", "moving"])
@pytest.mark.parametrize("crop_scope, jitter_key", PROFILES)
def test_jobs_hold_the_rows_of_a_gathering_worker(crop_scope, jitter_key, video, cursor):
    ds = _Videos(cursor)
    cfg = _cfg(crop_scope, jitter_key)
    got, want = _worker_jobs(ds, cfg, video), _gathered_jobs(ds, cfg, video)
    assert len(got) == len(want) == len(ds.video_groups()[video])
    if crop_scope == "clip" and video == 1:  # the box changes mid-video
        assert len({job.box.tobytes() for job in got}) > 1
    for g, w in zip(got, want):
        assert g.window_keys == w.keys
        _assert_rows_equal(g.miss, w.miss)
        _assert_rows_equal(g.cj_miss, w.cj_miss)
        assert (g.cj_window is None) == (w.cj_window is None)
        if w.cj_window is not None:
            assert g.cj_window.tobytes() == w.cj_window.tobytes()


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("crop_scope, jitter_key", PROFILES)
def test_a_first_seen_row_pins_only_its_jobs_new_rows(crop_scope, jitter_key, augment):
    ds = _Videos(cursor=True)
    for video in (0, 1):
        for job in _worker_jobs(ds, _cfg(crop_scope, jitter_key, augment), video):
            if not job.miss:
                continue
            row_bytes = job.miss[0][1].nbytes
            bases = {id(row.base) for _, row in job.miss}
            assert len(bases) == 1  # one crop output a job
            for _, row in job.miss:
                assert row.base is not None and row.base.nbytes <= len(job.miss) * row_bytes
                assert not np.shares_memory(row, ds.frames[video])


@pytest.mark.parametrize("crop_scope, jitter_key, per_job", [
    ("video", "video", 0),        # production
    ("video", "frame", 0),
    ("clip", "clip", SEQ_LEN),    # reference-keyed: the window is jittered
])
def test_rows_stacked_counts_the_clip_windows_rows(crop_scope, jitter_key, per_job):
    ds = _Videos(cursor=True)
    before = profiling.totals()
    jobs = _worker_jobs(ds, _cfg(crop_scope, jitter_key), 0)
    counts = profiling.since(before)["counts"]
    assert counts["h36x.extract.rows_stacked"] == per_job * len(jobs)
