"""The port's spans and counters (h36x_torch/utils/profiling.py) on the
CPU: no record_function without a profiler, a user_annotation on the main
thread's timeline under one, exact totals across threads, `measured`'s
gain a call, every span and counter of extraction in run_extract's
summary (the deterministic stand-in backbone of
tests/test_torch_extract.py), and the trainer's step still named
`train_step`."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from h36x_torch.config import ExtractConfig
from h36x_torch.extract import pipeline
from h36x_torch.utils import profiling
from h36x_torch.utils.profiling import count, span
from h36x_torch.utils.timers import PhaseTimers
from tests.test_dedup import FakeOverlapDataset
from tests.test_torch_extract import fake_port_backbone  # noqa: F401

MAIN_SPANS = {"h36x.extract.call", "h36x.extract.load_backbone", "h36x.extract.wait_jobs",
              "h36x.extract.stage", "h36x.extract.feature_fn", "h36x.extract.drain",
              "h36x.extract.store"}
WORKER_SPANS = {"h36x.extract.job", "h36x.extract.crop", "h36x.extract.jitter",
                "h36x.extract.put_wait", "h36x.store.write"}
# pad_rows moves only over a mesh (tests/test_torch_dispatch.py), rows_stacked
# only under jitter_key='clip' (tests/test_torch_worker_rows.py): the
# unique-frame scheduler counts both, at 0 here; rows_flipped, the hflip
# rows the device mirrors, only the unique-frame scheduler counts
COUNTERS = {"h36x.extract.frames_cropped", "h36x.extract.frames_jittered",
            "h36x.extract.jobs_ready", "h36x.extract.dispatches",
            "h36x.extract.pad_rows", "h36x.extract.rows_stacked",
            "h36x.extract.rows_flipped"}


def _chrome_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_span_without_a_profiler_builds_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = profiling.totals()
    for _ in range(3):
        with span("test.no_profiler"):
            pass
    count("test.no_profiler_counter", 5)
    got = profiling.since(before)
    seconds, calls = got["host_s"]["test.no_profiler"]
    assert calls == 3 and seconds >= 0.0
    assert got["counts"] == {"test.no_profiler_counter": 5}
    # the stand-in is what a span calls once a profiler runs
    with _cpu_profile(), pytest.raises(AssertionError, match="record_function"):
        with span("test.no_profiler"):
            pass


def test_span_is_a_user_annotation_on_the_main_thread(tmp_path):
    with _cpu_profile() as prof:
        with span("test.annotated"):
            torch.ones(4).add_(1)
    events = [e for e in _chrome_events(prof, tmp_path) if e.get("name") == "test.annotated"]
    assert len(events) == 1
    assert events[0]["cat"] == "user_annotation"
    assert events[0]["tid"] == threading.get_native_id()


def _run_threads(target, n_threads):
    threads = [threading.Thread(target=target) for _ in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)


def test_spans_on_four_threads_count_every_call():
    before = profiling.totals()

    def work():
        for _ in range(1000):
            with span("test.threads"):
                pass
            count("test.threads_counter")

    _run_threads(work, 4)
    got = profiling.since(before)
    assert got["host_s"]["test.threads"][1] == 4000
    assert got["counts"]["test.threads_counter"] == 4000


def test_measured_merges_and_keeps_each_calls_gain():
    def job(n):
        for _ in range(n):
            with span("test.measured.inner"):
                pass
        count("test.measured.items", n)
        return {"n": n}

    kept = len(profiling.measured_calls("test.measured"))
    out = [profiling.measured("test.measured", job, n) for n in (2, 5)]
    assert [o["n"] for o in out] == [2, 5]
    for o, n in zip(out, (2, 5)):
        assert o["host_s"]["test.measured"][1] == 1
        assert o["host_s"]["test.measured.inner"][1] == n
        assert o["counts"]["test.measured.items"] == n
        assert o["host_s"]["test.measured.inner"][0] <= o["host_s"]["test.measured"][0]
    gains = profiling.measured_calls("test.measured")[kept:]
    assert gains == [{k: o[k] for k in ("host_s", "counts")} for o in out]
    assert profiling.measured_calls("test.never_measured") == []


def test_phase_timers_time_one_phase_on_two_threads():
    timers = PhaseTimers()

    def work():
        for _ in range(500):
            timers.start("phase")
            timers.stop("phase")

    _run_threads(work, 2)
    assert timers.calls["phase"] == 1000
    assert timers.snapshot()["spans"]["phase"] == (timers.totals["phase"], 1000)


def _unique_frames(ds) -> int:
    frames = {}
    for ci in ds.clips:
        frames.setdefault(ci.video_idx, set()).update(range(ci.start, ci.end))
    return sum(len(f) for f in frames.values())


def _extract(tmp_path, ds, dedup):
    cfg = ExtractConfig(out=str(tmp_path / "store"), seq_len=8, resize=16, batch_size=2,
                        num_workers=2, augment=True, shard_size=3, shuffle_pool=100,
                        shuffle_seed=1, dedup=dedup)
    return pipeline.run_extract(cfg, dataset=ds, device="cpu")


@pytest.mark.parametrize("scheduler", ["unique_frame", "per_clip"])
def test_run_extract_reports_every_span_and_counter(tmp_path, fake_port_backbone,  # noqa: F811
                                                    scheduler):
    ds = FakeOverlapDataset(smooth=False)
    summary = _extract(tmp_path, ds, dedup=scheduler == "unique_frame")
    spans = MAIN_SPANS | WORKER_SPANS
    counters = COUNTERS
    if scheduler == "per_clip":
        spans = spans - {"h36x.extract.put_wait"}  # no job queue of its own
        counters = counters - {"h36x.extract.jobs_ready", "h36x.extract.dispatches",
                               "h36x.extract.pad_rows", "h36x.extract.rows_stacked",
                               "h36x.extract.rows_flipped"}
    assert set(summary["host_s"]) == spans
    assert summary["host_s"]["h36x.extract.call"][1] == 1
    assert summary["host_s"]["h36x.extract.load_backbone"][1] == 1
    assert set(summary["counts"]) == counters
    if scheduler == "unique_frame":  # production profile: one box, one jitter a video
        assert summary["crop_scope"] == summary["jitter_key"] == "video"
        unique = _unique_frames(ds)
        assert summary["counts"]["h36x.extract.frames_cropped"] == unique
        assert summary["counts"]["h36x.extract.frames_jittered"] == unique
        assert summary["backbone_frames"] == 3 * unique
        assert summary["host_s"]["h36x.extract.job"][1] == len(ds)
        assert summary["counts"]["h36x.extract.jobs_ready"] <= len(ds)
        # dispatches of batch_size * stride * 3 = 30 rows, the last shorter
        assert summary["counts"]["h36x.extract.dispatches"] == -(-3 * unique // 30)
        assert summary["counts"]["h36x.extract.pad_rows"] == 0
        assert summary["counts"]["h36x.extract.rows_stacked"] == 0
        assert summary["counts"]["h36x.extract.rows_flipped"] == unique
    else:
        assert summary["counts"]["h36x.extract.frames_cropped"] == len(ds) * 8
    call_s = summary["host_s"]["h36x.extract.call"][0]
    assert all(s <= call_s for n, (s, _) in summary["host_s"].items() if n in MAIN_SPANS)


def test_main_thread_spans_lie_inside_the_call(tmp_path, fake_port_backbone):  # noqa: F811
    with _cpu_profile() as prof:
        _extract(tmp_path, FakeOverlapDataset(smooth=False), dedup=True)
    main = threading.get_native_id()
    events = [e for e in _chrome_events(prof, tmp_path)
              if str(e.get("name", "")).startswith("h36x.extract.") and e.get("tid") == main]
    calls = [e for e in events if e["name"] == "h36x.extract.call"]
    assert len(calls) == 1
    a, b = calls[0]["ts"], calls[0]["ts"] + calls[0]["dur"]
    assert {e["name"] for e in events} == MAIN_SPANS
    assert all(a <= e["ts"] and e["ts"] + e["dur"] <= b for e in events)


def test_train_epoch_labels_its_step_train_step(tmp_path):
    from h36x_torch.data.features import FeatureClipDataset
    from h36x_torch.data.sampler import MixedShardBatchSampler
    from h36x_torch.parallel.feed import feed_dtype
    from h36x_torch.train.loop import train_epoch
    from tests.helpers import make_synthetic_store

    (tmp_path / "store").mkdir()
    make_synthetic_store(tmp_path / "store", n_shards=2, clips_per_shard=4, n_vars=1)
    ds = FeatureClipDataset(str(tmp_path / "store"), subjects=[1, 5], augment=False)
    sampler = MixedShardBatchSampler(ds, 2, shards_per_batch=2, shuffle=False, seed=0)

    class Step:
        group, graph_replays, eager_steps = 1, 0, 0

        def __call__(self, batch, generator):
            z = batch[0].float().mean()
            return {"loss": z, "l3d": z, "mpjpe": z}

    before = profiling.totals()
    with _cpu_profile() as prof:
        means = train_epoch(Step(), ds, sampler, torch.device("cpu"), feed_dtype("float32"),
                            torch.Generator(), log_every=0)
    steps = [e for e in _chrome_events(prof, tmp_path)
             if e.get("name") == "train_step" and e.get("cat") == "user_annotation"]
    n = len(sampler)
    assert n > 0 and len(steps) == n
    assert profiling.since(before)["host_s"]["train_step"][1] == n
    assert set(means["_timing"]) == {"data", "step", "drain"}
    assert np.isfinite(means["loss"])
