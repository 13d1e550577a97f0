"""h36x_torch's extraction slice against h36x on the CPU: the native host
library's bytes, the slice whole (the port's `run_extract` and h36x's on
one video-structured source with the deterministic stand-in backbone of
tests/test_dedup.py: byte-identical stores for both schedulers, with and
without augment, reference-keyed and production profiles), once more with
the real bfloat16 backbone on both sides from one torchvision `.pt`,
`h36x_torch.cli.extract --device cpu` on an mp4 tree, a crashed call
resumed to h36x's store under either scheduler, and the direction of the
extraction modules' imports."""

import ast
import dataclasses
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import h36x.extract.pipeline as jax_pipeline
from h36x import native as jax_native
from h36x.config import ExtractConfig as JaxExtractConfig
from h36x.data.augment import sample_jitter_params
from h36x.data.features import FeatureClipDataset as JaxFeatureClipDataset
from h36x_torch import native
from h36x_torch.cli.extract import main as extract_main
from h36x_torch.config import ExtractConfig
from h36x_torch.data import shards
from h36x_torch.data.features import FeatureClipDataset
from h36x_torch.extract import pipeline, staging
from tests.test_dedup import _PROJ, FakeOverlapDataset, fake_backbone  # noqa: F401
from tests.test_full_pipeline import ingested_tree  # noqa: F401
from tests.test_torch_resnet import torchvision_state_dict

# bfloat16 backbones of the two packages on the same pixels: flax's and
# torch's convolutions and BatchNorms round at different places, and 16
# blocks of bf16 compound it; a wrong pixel, weight or row is off by O(1)
REAL_BACKBONE_REL_NORM = 5e-2


@pytest.fixture
def fake_port_backbone(monkeypatch):
    """The stand-in of tests/test_dedup.py::fake_backbone for the port: the
    same per-row float64 projection of the u8 pixels, so both packages'
    stores must agree byte for byte."""

    def make(model, mesh=None, engine="flax"):
        def fn(frames):
            flat = frames.numpy().reshape(frames.shape[0], -1).astype(np.float64)
            return torch.from_numpy(np.tile(np.asarray(flat @ _PROJ, np.float32),
                                            (1, 2048 // 64)))

        return fn

    monkeypatch.setattr(pipeline, "_load_backbone", lambda cfg, device: None)
    monkeypatch.setattr(pipeline, "make_feature_fn", make)


def _store_files(root) -> dict:
    return {p.name: p.read_bytes() for p in sorted(Path(root).iterdir())}


def test_native_bytes_match_h36x_native():
    if not jax_native.available():
        pytest.skip("h36x's native library could not be built on this host")
    assert native.available() and native.jitter_available()
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(3, 50, 60, 3)).astype(np.uint8)
    for top, left, side, out in ((0, 0, 50, 16), (5, 8, 40, 24), (3, 17, 33, 7)):
        np.testing.assert_array_equal(
            native.crop_resize_clip(frames, top, left, side, out),
            jax_native.crop_resize_clip(frames, top, left, side, out))
    for seed in range(4):
        params = sample_jitter_params(np.random.default_rng(seed))
        np.testing.assert_array_equal(native.jitter_clip_u8(frames, params),
                                      jax_native.jitter_clip_u8(frames, params))
    with pytest.raises(ValueError, match="invalid crop box"):
        native.crop_resize_clip(frames, 40, 0, 20, 8)


def test_host_jitter_and_joint_flips_match_h36x():
    """The float32 jitter chain (h36x's pixel-space datasets use it) and
    the joint-side variant adjustments, from the same seeds."""
    from h36x.data import augment as jax_augment

    from h36x_torch.data import augment

    rng = np.random.default_rng(3)
    video = rng.random((2, 12, 10, 3), dtype=np.float32)
    np.testing.assert_array_equal(
        augment.color_jitter_host(video, np.random.default_rng(5)),
        jax_augment.color_jitter_host(video, np.random.default_rng(5)))
    j3d, j2d = rng.normal(size=(4, 17, 3)), rng.normal(size=(4, 17, 2))
    K = np.array([[500.0, 0, 12], [0, 500, 16], [0, 0, 1]], np.float32)
    for got, want in zip(augment.hflip_joints(j3d, j2d, K, width=32),
                         jax_augment.hflip_joints(j3d, j2d, K, width=32)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(augment.reverse_joints(j3d, j2d),
                         jax_augment.reverse_joints(j3d, j2d)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("scheduler, crop_scope, jitter_key", [
    ("per_clip", "clip", "clip"),
    ("unique_frame", "clip", "clip"),   # reference-keyed
    ("unique_frame", "auto", "auto"),   # production (video/video)
])
def test_store_is_byte_identical_to_h36x(tmp_path, fake_backbone,  # noqa: F811
                                         fake_port_backbone, scheduler, crop_scope,
                                         jitter_key, augment):
    ds = FakeOverlapDataset(smooth=False)
    kw = dict(seq_len=8, resize=16, batch_size=2, num_workers=2, augment=augment,
              shard_size=3, shuffle_pool=100, shuffle_seed=1, crop_scope=crop_scope,
              jitter_key=jitter_key, dedup=scheduler == "unique_frame")
    want = jax_pipeline.run_extract(JaxExtractConfig(out=str(tmp_path / "h36x"), **kw),
                                    dataset=ds)
    got = pipeline.run_extract(ExtractConfig(out=str(tmp_path / "port"), **kw),
                               dataset=ds, device="cpu")
    assert got["n_clips"] == want["n_clips"] == len(ds)
    if scheduler == "unique_frame":
        assert got["backbone_frames"] == want["backbone_frames"]
        assert (got["crop_scope"], got["jitter_key"]) == (want["crop_scope"],
                                                          want["jitter_key"])
    files = _store_files(tmp_path / "port")
    assert "index.json" in files and any(n.startswith("shard_") for n in files)
    assert files == _store_files(tmp_path / "h36x")
    assert shards.verify_store(tmp_path / "port")["errors"] == []


def _arrays(root):
    """{(subject, action, cam, start, aug): {array: row}} of a store, through
    h36x's reader."""
    ds = JaxFeatureClipDataset(root, augment=True, test_set=True)
    out = {}
    for i in range(len(ds)):
        feats, j3d, j2d, K, meta = ds[i]
        out[(meta["subject"], meta["action"], meta["cam"], meta["start"],
             meta["aug"])] = {
            "feats": np.asarray(feats), "joints3d": j3d, "joints2d": j2d, "K": K,
            "box": np.asarray(meta["box"])}
    return out


def test_real_backbone_store_matches_h36x(tmp_path):
    """bfloat16 backbones on both sides from one torchvision .pt: every
    non-feature array byte-equal, the features within
    REAL_BACKBONE_REL_NORM by relative norm."""
    weights = tmp_path / "resnet50.pt"
    torch.save(torchvision_state_dict(seed=1), weights)
    ds = FakeOverlapDataset(n_videos=1, smooth=True)
    kw = dict(seq_len=8, resize=32, batch_size=1, num_workers=1, augment=True,
              shard_size=2, shuffle_pool=100, shuffle_seed=1, weights=str(weights))
    jax_pipeline.run_extract(JaxExtractConfig(out=str(tmp_path / "h36x"), **kw), dataset=ds)
    pipeline.run_extract(ExtractConfig(out=str(tmp_path / "port"), **kw), dataset=ds,
                         device="cpu")
    assert (tmp_path / "port" / "index.json").read_bytes() == \
        (tmp_path / "h36x" / "index.json").read_bytes()
    want, got = _arrays(tmp_path / "h36x"), _arrays(tmp_path / "port")
    assert want.keys() == got.keys()
    f_want = np.stack([want[k]["feats"] for k in want])
    f_got = np.stack([got[k]["feats"] for k in want])
    assert np.isfinite(f_got).all() and np.abs(f_want).max() > 0
    rel = np.linalg.norm(f_got - f_want) / np.linalg.norm(f_want)
    assert rel <= REAL_BACKBONE_REL_NORM, rel
    for k in want:
        for name in ("joints3d", "joints2d", "K", "box"):
            np.testing.assert_array_equal(got[k][name], want[k][name], err_msg=f"{k} {name}")


def test_cli_extract_on_cpu(ingested_tree, tmp_path, capsys):  # noqa: F811
    """The entry point a user calls, on the mp4 tree of
    tests/test_full_pipeline.py, with the folded engine (its bottleneck
    blocks run the plain version on the CPU): a verified store that both
    packages' readers read."""
    out = tmp_path / "features"
    summary = extract_main([
        "--root", str(ingested_tree), "--out", str(out), "--seq-len", "8",
        "--stride", "4", "--frame-skip", "2", "--resize", "32", "--batch-size", "2",
        "--num-workers", "2", "--augment", "true", "--shard-size", "2",
        "--shuffle-pool", "50", "--subjects", "1", "5", "9", "--engine", "opt",
        "--verify-after", "true", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "[verify-after]" in printed and summary["device"] == "cpu"
    assert summary["n_clips"] == 12 and summary["crop_scope"] == "video"
    index = json.loads((out / "index.json").read_text())
    assert index["n_variants"] == 4 and index["aug_names"] == ["orig", "cjitter", "hflip", "trev"]
    port_ds = FeatureClipDataset(out, augment=True)
    jax_ds = JaxFeatureClipDataset(out, augment=True)
    assert len(port_ds) == len(jax_ds) == 48
    feats, j3d, j2d, K = port_ds.get_batch(list(range(8)))
    assert feats.shape == (8, 8, 2048) and np.isfinite(feats).all()
    np.testing.assert_array_equal(feats, np.stack([jax_ds[i][0] for i in range(8)]))
    with pytest.raises(SystemExit, match="required"):
        extract_main(["--out", str(out), "--device", "cpu"])


def test_rows_to_device_stacks_in_order_and_zero_pads():
    rng = np.random.default_rng(3)
    rows = [rng.integers(0, 256, (6, 6, 3), dtype=np.uint8) for _ in range(5)]
    rows[2] = rows[2][:, ::-1, :]  # a flipped view, as the dedup feed queues
    out = pipeline.rows_to_device(rows, 8, torch.device("cpu"))
    assert out.dtype == torch.uint8 and tuple(out.shape) == (8, 6, 6, 3)
    np.testing.assert_array_equal(out[:5].numpy(), np.stack(rows))
    assert not out[5:].any()
    full = pipeline.rows_to_device(rows, 5, torch.device("cpu"))
    np.testing.assert_array_equal(full.numpy(), np.stack(rows))


@pytest.mark.parametrize("n_rows", [5, 8], ids=["exact", "zero_padded"])
@pytest.mark.parametrize("flip", [0, 1, 3, 5])
def test_rows_to_device_mirrors_the_trailing_rows(n_rows, flip):
    """The last `flip` rows, given as their sources, arrive as the mirrored
    views a host stack would copy, byte for byte; the zero rows stay zero."""
    rng = np.random.default_rng(4)
    rows = [rng.integers(0, 256, (6, 7, 3), dtype=np.uint8) for _ in range(5)]
    views = rows[:5 - flip] + [r[:, ::-1, :] for r in rows[5 - flip:]]
    want = np.zeros((n_rows, 6, 7, 3), np.uint8)
    want[:5] = np.stack(views)
    before = np.stack(rows)
    out = pipeline.rows_to_device(rows, n_rows, torch.device("cpu"), flip=flip)
    assert out.dtype == torch.uint8 and out.is_contiguous()
    assert out.numpy().tobytes() == want.tobytes()
    np.testing.assert_array_equal(np.stack(rows), before)  # sources only read


def _mirrored_rows_run(tmp_path, monkeypatch, n_devices=1, **kw):
    """A unique-frame call on `n_devices` CPU devices under a stand-in
    backbone that keeps each dispatch's rows and features; returns the
    summary, the dispatches' rows, and the rows stored under each variant
    (counted at the assembler)."""
    from h36x_torch.extract import dedup
    from h36x_torch.utils import runtime

    seen = []

    def make(model, mesh=None, engine="flax"):
        def fn(frames):
            x = np.asarray(frames)
            seen.append(x.copy())
            flat = x.reshape(len(x), -1).astype(np.float64)
            return torch.from_numpy(np.tile(np.asarray(flat @ _PROJ, np.float32),
                                            (1, 2048 // 64)))

        return fn

    stored, store = {}, dedup._Assembler.store

    def counting(assembler, tag, row):
        var = tag[3] if tag[0] == "cache" else "clip"
        stored[var] = stored.get(var, 0) + 1
        store(assembler, tag, row)

    for module in (pipeline, runtime):
        monkeypatch.setattr(module, "local_devices",
                            lambda device, n=n_devices: [torch.device("cpu")] * n)
    monkeypatch.setattr(pipeline, "_load_backbone", lambda cfg, device: None)
    monkeypatch.setattr(pipeline, "make_feature_fn", make)
    monkeypatch.setattr(dedup._Assembler, "store", counting)
    cfg = ExtractConfig(**dict(dict(out=str(tmp_path), seq_len=8, stride=2, resize=16,
                                    batch_size=2, num_workers=2, augment=True,
                                    shard_size=4, shuffle_pool=100, shuffle_seed=1),
                               **kw))
    summary = pipeline.run_extract(cfg, dataset=FakeOverlapDataset(smooth=False),
                                   device="cpu")
    return summary, seen, stored


@pytest.mark.parametrize("kw, mirrored", [
    ({}, True),                                          # production (video/video)
    (dict(crop_scope="clip", jitter_key="clip"), True),  # reference-keyed
    (dict(augment=False), False),
    (dict(dedup=False), False),                          # the per-clip scheduler
], ids=["production", "reference_keyed", "no_augment", "per_clip"])
def test_rows_flipped_counts_the_hflip_rows_sent(tmp_path, monkeypatch, kw, mirrored):
    summary, seen, stored = _mirrored_rows_run(tmp_path, monkeypatch, **kw)
    flipped = summary["counts"].get("h36x.extract.rows_flipped", 0)
    sent = sum(len(f) for f in seen)
    if mirrored:
        assert flipped == stored["h"] == stored["o"] > 0
        assert summary["backbone_frames"] == sent
    else:
        assert flipped == 0 and "h" not in stored


def test_mirrored_rows_reach_the_backbone_as_the_host_stack_sent_them(tmp_path,
                                                                      monkeypatch):
    """Over a mesh the host still mirrors and sends each dispatch in queue
    order (rows_flipped 0); on one device each dispatch holds the same rows,
    the mirrored ones last: the same bytes, and the same store."""
    one, rows_one, _ = _mirrored_rows_run(tmp_path / "one", monkeypatch)
    two, rows_two, _ = _mirrored_rows_run(tmp_path / "two", monkeypatch, n_devices=2)
    assert two["counts"]["h36x.extract.rows_flipped"] == 0
    assert one["counts"]["h36x.extract.rows_flipped"] > 0
    assert [len(f) for f in rows_one] == [len(f) for f in rows_two]
    for a, b in zip(rows_one, rows_two):
        key = [r.tobytes() for r in a]
        assert sorted(key) == sorted(r.tobytes() for r in b)
    assert _store_files(tmp_path / "one") == _store_files(tmp_path / "two")


class _Flaky(FakeOverlapDataset):
    """FakeOverlapDataset whose clip `fail_at` raises, as a bad annotation
    or a decode error would."""

    def __init__(self, fail_at=None, **kw):
        super().__init__(smooth=False, **kw)
        self.fail_at = fail_at

    def clip_annotations(self, i):
        if i == self.fail_at:
            raise RuntimeError("simulated crash")
        return super().clip_annotations(i)


# small pools and dispatches, so shards and progress land before clip 5
CRASH = dict(seq_len=8, resize=16, batch_size=2, num_workers=2, augment=True,
             shard_size=2, shuffle_pool=2, shuffle_seed=1, frames_per_dispatch=12)
PER_CLIP = dict(dedup=False)
REFERENCE_KEYED = dict(crop_scope="clip", jitter_key="clip")


def _crash(out, **kw) -> ExtractConfig:
    """A call that fails at clip 5: its error reaches the caller, progress.json
    is on disk at once, and no thread the call started is left alive."""
    cfg = ExtractConfig(out=str(out), **CRASH, **kw)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="simulated crash"):
        pipeline.run_extract(cfg, dataset=_Flaky(fail_at=5), device="cpu")
    assert (out / "progress.json").exists()
    assert [t for t in threading.enumerate() if t not in before] == []
    return cfg


@pytest.mark.parametrize("crashed, resumed", [
    (PER_CLIP, PER_CLIP),
    (REFERENCE_KEYED, REFERENCE_KEYED),
    ({}, {}),                       # production (video/video)
    (PER_CLIP, REFERENCE_KEYED),    # across the schedulers
], ids=["per_clip", "unique_frame-clip", "unique_frame-production",
        "per_clip-then-unique_frame"])
def test_a_crashed_call_resumes_to_h36x_store(tmp_path, fake_backbone,  # noqa: F811
                                              fake_port_backbone, crashed, resumed):
    cfg = _crash(tmp_path / "port", **crashed)
    cfg = dataclasses.replace(cfg, resume=True, **resumed)
    summary = pipeline.run_extract(cfg, dataset=_Flaky(), device="cpu")
    assert summary["n_clips"] == len(_Flaky()) > summary["n_processed"]
    assert not (tmp_path / "port" / "progress.json").exists()
    assert shards.verify_store(tmp_path / "port")["errors"] == []
    jax_pipeline.run_extract(JaxExtractConfig(out=str(tmp_path / "h36x"), **CRASH, **resumed),
                             dataset=FakeOverlapDataset(smooth=False))
    want, got = _arrays(tmp_path / "h36x"), _arrays(tmp_path / "port")
    assert got.keys() == want.keys()
    for key in want:
        for name, row in want[key].items():
            np.testing.assert_array_equal(got[key][name], row, err_msg=f"{key} {name}")


def test_a_resume_that_flips_save_fp16_is_refused(tmp_path, fake_port_backbone):  # noqa: F811
    cfg = _crash(tmp_path / "port", save_fp16=True)
    before = set(threading.enumerate())
    with pytest.raises(ValueError, match="resume config mismatch"):
        pipeline.run_extract(dataclasses.replace(cfg, resume=True, save_fp16=False),
                             dataset=_Flaky(), device="cpu")
    assert [t for t in threading.enumerate() if t not in before] == []


def _imports(path) -> set:
    """The modules a source file imports, and each `from` name as module.name."""
    names = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def test_extraction_imports_point_one_way():
    """pipeline -> dedup -> staging, pipeline -> store, and no arrow back."""
    package = Path(pipeline.__file__).parent
    stage = {"h36x_torch.extract.pipeline", "h36x_torch.extract.dedup"}
    for name in ("store.py", "staging.py"):
        assert not _imports(package / name) & stage, name
    assert "h36x_torch.extract.pipeline" not in _imports(package / "dedup.py")
    assert "h36x_torch.extract.pipeline" not in _imports(package.parent / "data" / "clips.py")
    for name in ("DeviceFeatures", "crop_resize_frames", "rows_to_device"):
        assert getattr(pipeline, name) is getattr(staging, name), name
