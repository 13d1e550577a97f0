"""How h36x_torch's unique-frame scheduler (extract/dedup.py) sends rows to
the backbone, on the CPU: by default a dispatch carries the rows that
`batch_size` clips add in steady state under the call's resolved profile
and goes as soon as that many are pending; the last goes at its own size,
with no zero row on one device and, over a mesh, padding only to the data
axis; the store is the same at any dispatch size; the feed's byte budget
stays a per-clip batch of crop rows; and the summary's counters count the
dispatches and the zero rows. The backbone is the deterministic stand-in
of tests/test_torch_extract.py, watched by a spy."""

import numpy as np
import pytest
import torch

from h36x_torch.config import ExtractConfig
from h36x_torch.data.features import FeatureClipDataset
from h36x_torch.extract import dedup, pipeline
from h36x_torch.extract.pipeline import resolve_extract_modes
from tests.test_dedup import FakeOverlapDataset
from tests.test_torch_extract import _store_files, fake_port_backbone  # noqa: F401

# 3 videos of 30 subsampled frames, a clip every 2: 90 rows a video under
# the production profile, more than one default dispatch
VIDEOS = dict(n_videos=3, n_sub=30, seq_len=8, stride=2, smooth=True)


def _cfg(out, **kw):
    base = dict(out=str(out), seq_len=8, stride=2, resize=16, batch_size=2,
                num_workers=2, augment=True, shard_size=4, shuffle_pool=100,
                shuffle_seed=1, dedup=True)
    return ExtractConfig(**dict(base, **kw))


def _chunks(total, size):
    """`total` rows in dispatches of `size`, the last at its own size."""
    return [size] * (total // size) + ([total % size] if total % size else [])


@pytest.fixture
def spy(monkeypatch, fake_port_backbone):  # noqa: F811
    """The stand-in backbone, each dispatch's frames kept as they reach it."""
    seen = []
    make = pipeline.make_feature_fn

    def spying(model, mesh=None, engine="flax"):
        fn = make(model, mesh=mesh, engine=engine)

        def call(frames):
            seen.append(frames.numpy().copy())
            return fn(frames)

        return call

    monkeypatch.setattr(pipeline, "make_feature_fn", spying)
    return seen


@pytest.mark.parametrize("crop_scope, jitter_key, augment, granule", [
    ("auto", "auto", True, 2 * 2 * 3),           # production: stride x 3 a clip
    ("video", "frame", True, 2 * 2 * 3),
    ("clip", "clip", True, 2 * (8 + 2 * 2)),     # the clip's jittered window too
    ("auto", "auto", False, 2 * 2),              # stride a clip
])
def test_dispatches_are_the_granule_and_an_exact_tail(tmp_path, spy, crop_scope,
                                                      jitter_key, augment, granule):
    summary = pipeline.run_extract(
        _cfg(tmp_path / "store", crop_scope=crop_scope, jitter_key=jitter_key,
             augment=augment),
        dataset=FakeOverlapDataset(**VIDEOS), device="cpu")
    sizes = [len(f) for f in spy]
    total = summary["backbone_frames"]
    assert total % granule  # the tail is short, so it shows
    assert sizes == _chunks(total, granule)
    # random pixels: a zero row could only be padding
    assert all(f.reshape(len(f), -1).any(axis=1).all() for f in spy)
    counts = summary["counts"]
    assert counts["h36x.extract.dispatches"] == len(sizes)
    assert counts.get("h36x.extract.pad_rows", 0) == 0


def test_the_default_follows_the_resolved_profile_at_the_cells_sizes():
    """At the extraction cells' sizes (batch 32, seq_len 40, stride 5, 4
    variants, the production profile): 480 rows a dispatch, so 6,000
    backbone rows go as 12 dispatches and a 240-row tail; the feed keeps
    3,840 crop rows of budget."""
    cfg = resolve_extract_modes(
        ExtractConfig(batch_size=32, seq_len=40, stride=5, resize=256, augment=True),
        production=True)
    size = dedup.default_frames_per_dispatch(cfg)
    assert size == 480
    assert _chunks(6000, size) == [480] * 12 + [240]
    assert dedup._feed_budget(cfg, size) == 3840 * 256 * 256 * 3


@pytest.mark.parametrize("frames_per_dispatch", [0, 96, 1])
def test_the_feed_budget_keeps_a_per_clip_batch_of_crop_rows(tmp_path, monkeypatch,
                                                             fake_port_backbone,  # noqa: F811
                                                             frames_per_dispatch):
    """The budget the call gives its feed: batch_size * seq_len * 3 crop
    rows (48 here) at the default and below it, a dispatch's above it."""
    budgets, init = [], dedup._Feed.__init__

    def spying(feed, n_videos, budget):
        budgets.append(budget)
        init(feed, n_videos, budget)

    monkeypatch.setattr(dedup._Feed, "__init__", spying)
    cfg = _cfg(tmp_path / "store", frames_per_dispatch=frames_per_dispatch)
    pipeline.run_extract(cfg, dataset=FakeOverlapDataset(**VIDEOS), device="cpu")
    rows = max(2 * 8 * 3, frames_per_dispatch)
    assert budgets == [rows * 16 * 16 * 3]


def test_the_first_dispatch_goes_before_video_0_is_done(tmp_path, monkeypatch, spy):
    """Video 0 has 90 rows: fewer than a per-clip batch (4 x 8 x 3 = 96),
    more than three default dispatches (4 x 2 x 3 = 24). The backbone gets
    those three before the consumer takes video 0's "done"."""
    events, advance = [], dedup._Feed.advance

    def advancing(feed):
        events.append(("done", len(spy)))
        advance(feed)

    monkeypatch.setattr(dedup._Feed, "advance", advancing)
    summary = pipeline.run_extract(_cfg(tmp_path / "store", batch_size=4),
                                   dataset=FakeOverlapDataset(**VIDEOS), device="cpu")
    assert summary["n_clips"] == len(FakeOverlapDataset(**VIDEOS))
    assert events[0] == ("done", 90 // 24)
    assert [len(f) for f in spy[:3]] == [24] * 3


@pytest.mark.parametrize("frames_per_dispatch", [
    0,          # the default: 2 x 2 x 3 rows
    2 * 8 * 3,  # a per-clip batch, the size the feed's budget keeps
    7,          # ragged: a dispatch ends inside a clip's rows
])
def test_the_store_is_the_same_at_any_dispatch_size(tmp_path, fake_port_backbone,  # noqa: F811
                                                    frames_per_dispatch):
    """Against one row a dispatch, with boxes that drift (part dedup): a
    row's features depend on its own pixels alone."""
    ds = FakeOverlapDataset(**dict(VIDEOS, smooth=False))
    pipeline.run_extract(_cfg(tmp_path / "one", frames_per_dispatch=1), dataset=ds,
                         device="cpu")
    pipeline.run_extract(_cfg(tmp_path / "got", frames_per_dispatch=frames_per_dispatch),
                         dataset=ds, device="cpu")
    files = _store_files(tmp_path / "got")
    assert any(n.startswith("shard_") for n in files)
    assert files == _store_files(tmp_path / "one")


@pytest.mark.parametrize("frames_per_dispatch", [0, 5])
def test_over_a_mesh_a_dispatch_pads_only_to_the_data_axis(tmp_path, monkeypatch,
                                                           frames_per_dispatch):
    """Two local devices (tests/test_torch_mesh.py's set-up): each
    dispatch reaches the mesh's feature function at its own size and is
    padded only to a multiple of 2 (the default's 15 rows and the 12-row
    tail; 5-row dispatches and a 2-row tail), `pad_rows` counts those rows,
    and the store is one device's: the non-feature arrays byte-equal, the
    features within 1e-5 by relative norm."""
    from h36x_torch.models.resnet import ResNet50
    from h36x_torch.parallel import local
    from h36x_torch.utils import runtime

    monkeypatch.setattr(pipeline, "_load_backbone",
                        lambda cfg, device: ResNet50(dtype=torch.float32, device=device))
    padded, pad = [], local.pad_rows

    def padding(x, parts):
        out = pad(x, parts)
        padded.append((len(x), len(out)))
        return out

    monkeypatch.setattr(local, "pad_rows", padding)
    ds = FakeOverlapDataset(n_videos=1, smooth=True)
    kw = dict(seq_len=8, stride=5, resize=16, batch_size=1, num_workers=1, augment=True,
              shard_size=2, shuffle_pool=100, shuffle_seed=1,
              frames_per_dispatch=frames_per_dispatch)
    summaries = {}
    for name, n_devices in (("one", 1), ("two", 2)):
        for module in (pipeline, runtime):
            monkeypatch.setattr(module, "local_devices",
                                lambda device, n=n_devices: [torch.device("cpu")] * n)
        padded.clear()
        torch.manual_seed(3)
        summaries[name] = pipeline.run_extract(
            ExtractConfig(out=str(tmp_path / name), **kw), dataset=ds, device="cpu")
    total = summaries["two"]["backbone_frames"]
    want = _chunks(total, frames_per_dispatch or 1 * 5 * 3)
    assert [n for n, _ in padded] == want
    assert [m for _, m in padded] == [n + n % 2 for n in want]
    assert any(n % 2 for n in want)  # some dispatch is padded
    counts = summaries["two"]["counts"]
    assert counts["h36x.extract.dispatches"] == len(want)
    assert counts["h36x.extract.pad_rows"] == sum(n % 2 for n in want)
    assert summaries["one"]["counts"].get("h36x.extract.pad_rows", 0) == 0
    assert (tmp_path / "one" / "index.json").read_bytes() == \
        (tmp_path / "two" / "index.json").read_bytes()
    one = FeatureClipDataset(tmp_path / "one", augment=True, test_set=True)
    two = FeatureClipDataset(tmp_path / "two", augment=True, test_set=True)
    idx = list(range(len(one)))
    a, b = one.get_batch(idx), two.get_batch(idx)
    for x, y in zip(a[1:4], b[1:4]):
        np.testing.assert_array_equal(x, y)
    rel = np.linalg.norm(b[0] - a[0]) / np.linalg.norm(a[0])
    assert np.isfinite(b[0]).all() and rel <= 1e-5, rel
