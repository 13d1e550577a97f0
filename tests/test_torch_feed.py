"""The feed of h36x_torch's unique-frame scheduler (extract/dedup.py's
`_Feed`) on the CPU: the videos after the one being consumed crop ahead
under one byte budget, and the store stays byte for byte the same whatever
the budget; a slow first video lets the later ones finish first; the bytes
queued for later videos stay within the budget; an error on either side
ends the call within a time limit; and the feed's bookkeeping under many
threads. The backbone is the deterministic stand-in of
tests/test_torch_extract.py."""

import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from h36x_torch.config import ExtractConfig
from h36x_torch.extract import dedup, pipeline
from tests.test_dedup import FakeOverlapDataset
from tests.test_torch_extract import _store_files, fake_port_backbone  # noqa: F401

# a call that has not returned by then hangs
CALL_LIMIT_S = 60.0
# 3 videos of 23 overlapping clips: more jobs a video than the consumer's
# video may hold queued
VIDEOS = dict(n_videos=3, n_sub=30, seq_len=8, stride=1, smooth=False)
PROFILES = [("clip", "clip"),     # reference-keyed: a jittered window a job
            ("auto", "auto"),     # production (video/video)
            ("video", "frame")]   # mixed


def _cfg(out, crop_scope="auto", jitter_key="auto", **kw):
    base = dict(out=str(out), seq_len=8, resize=16, batch_size=2, num_workers=4,
                augment=True, shard_size=8, shuffle_pool=100, shuffle_seed=1,
                crop_scope=crop_scope, jitter_key=jitter_key, dedup=True)
    return ExtractConfig(**dict(base, **kw))


def _run_bounded(cfg, ds) -> dict:
    """run_extract on another thread, joined within CALL_LIMIT_S: its
    summary or the error it raised."""
    out = {}

    def call():
        try:
            out["summary"] = pipeline.run_extract(cfg, dataset=ds, device="cpu")
        except BaseException as e:  # handed to the test thread
            out["error"] = e

    thread = threading.Thread(target=call, daemon=True)
    thread.start()
    thread.join(CALL_LIMIT_S)
    assert not thread.is_alive(), f"run_extract still running after {CALL_LIMIT_S} s"
    return out


class _SlowFirstVideo(FakeOverlapDataset):
    """Video 0's clips wait on `gate` (an Event, or seconds to sleep)."""

    def __init__(self, gate):
        super().__init__(**VIDEOS)
        self.gate = gate
        self.waited = []

    def clip_annotations(self, i):
        if self.clips[i].video_idx == 0:
            if isinstance(self.gate, threading.Event):
                self.waited.append(self.gate.wait(CALL_LIMIT_S / 2))
            else:
                time.sleep(self.gate)
        return super().clip_annotations(i)


@pytest.mark.parametrize("crop_scope, jitter_key", PROFILES)
def test_a_budget_below_one_job_writes_the_same_store(tmp_path, monkeypatch,
                                                      fake_port_backbone,  # noqa: F811
                                                      crop_scope, jitter_key):
    ds = FakeOverlapDataset(**VIDEOS)
    want = _run_bounded(_cfg(tmp_path / "default", crop_scope, jitter_key), ds)
    monkeypatch.setattr(dedup, "_feed_budget", lambda cfg, frames_per_dispatch: 1)
    got = _run_bounded(_cfg(tmp_path / "one_job", crop_scope, jitter_key), ds)
    assert "error" not in want and "error" not in got
    assert got["summary"]["n_clips"] == want["summary"]["n_clips"] == len(ds)
    files = _store_files(tmp_path / "one_job")
    assert any(n.startswith("shard_") for n in files)
    assert files == _store_files(tmp_path / "default")


def test_later_videos_finish_while_the_first_is_slow(tmp_path, monkeypatch,
                                                     fake_port_backbone):  # noqa: F811
    """Video 0's worker starts its first clip only once the workers of
    videos 1 and 2 have returned: each of them runs 23 jobs ahead, more
    than the consumer's video may hold, so a feed that held each later
    video to that depth would keep them waiting on video 0."""
    others_done = threading.Event()
    ds = _SlowFirstVideo(others_done)
    finished, lock = set(), threading.Lock()
    real = dedup._video_worker

    def worker(dataset, group, *args):
        real(dataset, group, *args)
        with lock:
            finished.add(dataset.clips[group[0]].video_idx)
            if finished >= {1, 2}:
                others_done.set()

    monkeypatch.setattr(dedup, "_video_worker", worker)
    # one dispatch of crop rows holds what videos 1 and 2 queue (2 x 60 rows)
    out = _run_bounded(_cfg(tmp_path / "store", frames_per_dispatch=256), ds)
    assert "error" not in out
    assert ds.waited and all(ds.waited), "videos 1 and 2 did not finish ahead of video 0"
    n_later = sum(1 for ci in ds.clips if ci.video_idx > 0)
    assert out["summary"]["counts"]["h36x.extract.jobs_ready"] >= n_later
    assert out["summary"]["n_clips"] == len(ds)


@pytest.mark.parametrize("crop_scope, jitter_key", PROFILES[:2])
def test_bytes_queued_for_later_videos_stay_within_the_budget(tmp_path, monkeypatch,
                                                              fake_port_backbone,  # noqa: F811
                                                              crop_scope, jitter_key):
    """Sampled after every put of the workers, from the jobs in the queues
    of the videos after the consumer's; the budget is one dispatch of crop
    rows (2 x 8 x 3 of 16 x 16 x 3 bytes), which video 0's sleeps let the
    later videos fill."""
    budget = 2 * 8 * 3 * 16 * 16 * 3
    samples, real_put = [], dedup._Feed.put

    def job_bytes(job):
        return (sum(c.nbytes for _, c in job.miss) + sum(c.nbytes for _, c in job.cj_miss)
                + (job.cj_window.nbytes if job.cj_window is not None else 0))

    def put(feed, pos, item):
        real_put(feed, pos, item)
        with feed.cond:
            later = sum(job_bytes(it[1]) for q in feed.queues[feed.current + 1:]
                        for it, _ in q if it[0] == "job")
            samples.append((later, feed.ahead, feed.budget))

    monkeypatch.setattr(dedup._Feed, "put", put)
    out = _run_bounded(_cfg(tmp_path / "store", crop_scope, jitter_key),
                       _SlowFirstVideo(0.01))
    assert "error" not in out
    assert {b for _, _, b in samples} == {budget}
    assert all(later == ahead for later, ahead, _ in samples)
    assert 0 < max(later for later, _, _ in samples) <= budget


def test_a_worker_error_in_a_later_video_ends_the_call(tmp_path, fake_port_backbone):  # noqa: F811
    class Broken(_SlowFirstVideo):
        def clip_annotations(self, i):
            ci = self.clips[i]
            if ci.video_idx == 2 and ci.start == 2:
                raise RuntimeError("video 2 cannot be read")
            return super().clip_annotations(i)

    out = _run_bounded(_cfg(tmp_path / "store"), Broken(0.01))
    assert isinstance(out.get("error"), RuntimeError)
    assert "video 2 cannot be read" in str(out["error"])


def test_a_consumer_error_releases_workers_waiting_on_the_budget(tmp_path, monkeypatch,
                                                                 fake_port_backbone):  # noqa: F811
    """The backbone fails on its second dispatch while the later videos'
    workers wait for room under a budget below one job."""
    monkeypatch.setattr(dedup, "_feed_budget", lambda cfg, frames_per_dispatch: 1)
    make = pipeline.make_feature_fn
    dispatches = []

    def failing(model, mesh=None, engine="flax"):
        fn = make(model, mesh=mesh, engine=engine)

        def call(frames):
            dispatches.append(len(frames))
            if len(dispatches) == 2:
                raise RuntimeError("the device went away")
            return fn(frames)

        return call

    monkeypatch.setattr(pipeline, "make_feature_fn", failing)
    out = _run_bounded(_cfg(tmp_path / "store"), _SlowFirstVideo(0.005))
    assert isinstance(out.get("error"), RuntimeError)
    assert "the device went away" in str(out["error"])


def test_the_feed_keeps_order_and_bytes_under_many_threads():
    """16 video workers (more than this host's cores) put jobs of random
    bytes at a short switch interval; the consumer takes them all in video
    and put order, the later videos' bytes stay within the budget at every
    put, and every byte counted in is counted out."""
    n_videos, n_jobs, budget = 16, 40, 5_000
    rng = np.random.default_rng(7)
    sizes = rng.integers(1, 2_000, size=(n_videos, n_jobs))
    feed = dedup._Feed(n_videos, budget)
    over, got = [], []

    def worker(pos):
        for j in range(n_jobs):
            feed.put(pos, ("job", SimpleNamespace(nbytes=int(sizes[pos, j]), tag=(pos, j))))
            with feed.cond:
                if feed.ahead > budget:
                    over.append(feed.ahead)
        feed.put(pos, ("done", None))

    def consumer():
        for _ in range(n_videos):
            while True:
                (kind, job), _ = feed.get()
                if kind == "done":
                    feed.advance()
                    break
                got.append(job.tag)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(p,), daemon=True)
                   for p in range(n_videos)]
        threads.append(threading.Thread(target=consumer, daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join(CALL_LIMIT_S)
        assert not any(t.is_alive() for t in threads), "the feed hung"
    finally:
        sys.setswitchinterval(switch)
    assert got == [(p, j) for p in range(n_videos) for j in range(n_jobs)]
    assert over == []
    assert feed.ahead == 0 and feed.queued == [0] * n_videos
