"""The HRNet-W48 backbone (h36x_torch/models/hrnet.py) on the CPU at a tiny
size (branches 8, 16, 32, 64 wide, one module a stage, one block a branch,
stem 16, head 4, 8, 16, 32, feature 64, 128-pixel crops read as 128 x 96):
against the plain reference of tests/hrnet_reference.py on seeded
weights, planted faults, its column slice and flip, its state_dict loader
and refused sizes, its spans and counters, and `run_extract(backbone=
'hrnet_w48')` on both schedulers and over two local devices, with PHD
trained from the store it writes; at the published widths, its sizes on
`meta` and the seeded draw's stream sizes."""

from __future__ import annotations

import json
import re

import numpy as np
import pytest
import torch
from torch import nn

from h36x_torch.config import BACKBONE_FEATURE_DIM, BACKBONES, ExtractConfig
from h36x_torch.data.features import FeatureClipDataset
from h36x_torch.extract import pipeline, store
from h36x_torch.models import hrnet
from h36x_torch.utils import profiling
from tests import hrnet_reference as ref
from tests.test_dedup import FakeOverlapDataset
from tests.test_full_pipeline import ingested_tree  # noqa: F401
from tests.test_torch_vit import _same_store, _store

TINY = dict(img_size=(128, 96), stem=16, stage1_blocks=1, stage1_width=8,
            channels=(8, 16, 32, 64), modules=(1, 1, 1), blocks=1, head=(4, 8, 16, 32),
            feature=64, eps=1e-5)
# float32 against float32: the same sums in another order (channels_last
# convs against NCHW ones); readings 2.1e-7 to 2.4e-7
F32_REL = 1e-5
# bfloat16 weights and activations against float32: about 2^-8 a rounding
# at each of the 50 convs, norms, sums and the cast of the input; readings
# 4.1e-3 to 6.1e-3 over five seeds (3, 11, 23, 5, 7). Every planted fault
# reads over three times it (test_faults_read_far_above...)
BF16_REL = 1e-2


def _weights(seed=3, sizes=TINY):
    return ref.make_weights(sizes, torch.Generator().manual_seed(seed))


def _frames(n=12, side=128, seed=4):
    return torch.randint(0, 256, (n, side, side, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))


def _port(w, dtype=torch.float32, sizes=TINY):
    return hrnet.load_hrnet(hrnet.HRNet(dtype=dtype, **sizes), w, "cpu")


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


def _run(model, frames):
    with torch.inference_mode():
        return model(frames)


@pytest.mark.parametrize("seed", [3, 11])
def test_float32_port_matches_the_reference(seed):
    w, x = _weights(seed), _frames(seed=seed + 1)
    got = _run(_port(w), x)
    assert got.dtype == torch.float32 and got.shape == (12, 64)
    assert _rel(got, ref.forward(w, x, TINY)) <= F32_REL


@pytest.mark.parametrize("seed", [3, 11, 23, 5, 7])
def test_bfloat16_port_matches_the_reference_within_its_rounding(seed):
    w, x = _weights(seed), _frames(seed=seed + 1)
    model = _port(w, torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert model.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    got = _run(model, x)
    assert got.dtype == torch.float32
    assert 0 < _rel(got, ref.forward(w, x, TINY)) <= BF16_REL


class _Nothing(nn.Module):
    def forward(self, x):
        return 0


def _drop_fusion_path(model):
    # the last module's path from branch 1 into branch 0
    model.stage4[-1].fuse_layers[0][1] = _Nothing()


def _bilinear(model):
    for m in model.modules():
        if isinstance(m, nn.Upsample):
            m.mode = "bilinear"


def _drop_residual(model):
    blk = model.stage4[-1].branches[0][0]
    blk.forward = lambda x: torch.relu(blk.bn2(blk.conv2(torch.relu(blk.bn1(blk.conv1(x))))))


def _left_columns(model):
    model.columns = lambda side: slice(0, model.img_size[1])


# readings at seed 3: 0.077, 0.044, 0.19, about 0.16
@pytest.mark.parametrize("fault", [_drop_fusion_path, _bilinear, _drop_residual,
                                   _left_columns])
def test_faults_read_far_above_the_bfloat16_tolerance(fault):
    w, x = _weights(), _frames()
    want = ref.forward(w, x, TINY)
    model = _port(w)
    assert _rel(_run(model, x), want) <= F32_REL
    fault(model)
    assert _rel(_run(model, x), want) > 3 * BF16_REL


def test_only_the_middle_columns_are_read():
    model, x = _port(_weights()), _frames()
    assert model.columns(128) == slice(16, 112)
    y = x.clone()
    y[:, :, :16] = 0
    y[:, :, 112:] = 255
    torch.testing.assert_close(_run(model, y), _run(model, x), rtol=0, atol=0)
    z = x.clone()
    z[:, :, 16] = 255 - z[:, :, 16]
    assert _rel(_run(model, z), _run(model, x)) > 1e-4
    with pytest.raises(ValueError, match="--resize 128"):
        _run(model, _frames(side=96))


def test_the_flip_commutes_with_the_symmetric_slice():
    model, x = _port(_weights()), _frames()
    cols = model.columns(128)
    assert torch.equal(x.flip(2)[:, :, cols], x[:, :, cols].flip(2))
    y = torch.zeros_like(x)
    y[:, :, cols] = x[:, :, cols].flip(2)
    torch.testing.assert_close(_run(model, x.flip(2)), _run(model, y), rtol=0, atol=0)


@pytest.mark.parametrize("prefix", ["", "encoder.", "backbone."])
def test_state_dict_round_trip(prefix):
    w = _weights()
    model = _port(w)
    sd = {prefix + k: v.clone() for k, v in model.state_dict().items()}
    # cls_hrnet.py's classifier beside the backbone
    sd[prefix + "classifier.weight"] = torch.zeros(1000, 64)
    sd[prefix + "classifier.bias"] = torch.zeros(1000)
    again = hrnet.load_hrnet(hrnet.HRNet(dtype=torch.float32, **TINY), sd, "cpu")
    assert again.state_dict().keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    assert all(not p.requires_grad and p.device.type == "cpu" for p in again.parameters())
    # the reference's names are the module's, BatchNorm's step counter aside
    assert set(w) == {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}


def test_loader_refuses_another_layout(tmp_path):
    from h36x_torch.models.resnet import ResNet50

    w = _weights()
    with pytest.raises(KeyError, match="missing"):
        hrnet.load_hrnet(hrnet.HRNet(**TINY), {k: v for k, v in w.items()
                                               if ".fuse_layers.0.1." not in k}, "cpu")
    with pytest.raises(KeyError, match="other shapes"):
        hrnet.load_hrnet(hrnet.HRNet(**dict(TINY, feature=32)), w, "cpu")
    resnet = ResNet50(dtype=torch.float32, device="cpu", stage_sizes=(1, 1, 1, 1))
    with pytest.raises(KeyError, match="not this HRNet's state_dict"):
        hrnet.load_hrnet(hrnet.HRNet(**TINY), resnet.state_dict(), "cpu")
    path = tmp_path / "w.pt"
    torch.save({"state_dict": {"encoder." + k: v for k, v in w.items()}}, path)
    model = hrnet.load_hrnet_file(hrnet.HRNet(dtype=torch.float32, **TINY), path, "cpu")
    assert torch.equal(model.final_layer[0].bias, w["final_layer.0.bias"])


@pytest.mark.parametrize("sizes", [dict(img_size=(128, 80)), dict(img_size=(112, 96)),
                                   dict(modules=(1, 1)), dict(head=(4, 8, 16))])
def test_sizes_without_exact_steps_or_matching_stages_are_refused(sizes):
    with pytest.raises(ValueError):
        hrnet.HRNet(**dict(TINY, **sizes))


def test_spans_and_counters_of_a_dispatch():
    model, x = _port(_weights(), torch.bfloat16), _frames(n=5)
    before = profiling.totals()
    _run(model, x)
    gained = profiling.since(before)
    calls = {k: c for k, (_, c) in gained["host_s"].items() if k.startswith("h36x.hrnet.")}
    modules = sum(TINY["modules"])
    assert calls == {"h36x.hrnet.stem": 1, "h36x.hrnet.transition": 3,
                     "h36x.hrnet.branches": modules, "h36x.hrnet.fuse": modules,
                     "h36x.hrnet.head": 1}
    assert gained["counts"]["h36x.hrnet.frames"] == 5
    # 2 + 6 + 12 paths over stages of 2, 3 and 4 branches
    assert gained["counts"]["h36x.hrnet.fuse_paths"] == 20 == ref.fuse_paths(TINY)


def test_published_sizes_and_widths():
    model = hrnet.HRNet()  # on meta: no weights drawn
    assert next(model.parameters()).device.type == "meta"
    assert sum(p.numel() for p in model.parameters()) == 75_420_864
    convs = [m for m in model.modules() if isinstance(m, nn.Conv2d)]
    norms = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    assert len(convs) == len(norms) == 325 and all(m.eps == 1e-5 for m in norms)
    paths = sum(p is not None for s in (2, 3, 4) for mod in getattr(model, f"stage{s}")
                for row in mod.fuse_layers for p in row)
    assert paths == 62 == ref.fuse_paths(hrnet.HRNET_W48)
    assert [len(getattr(model, f"stage{s}")) for s in (2, 3, 4)] == [1, 4, 3]
    assert BACKBONE_FEATURE_DIM == {"resnet50": 2048, "vit_h": 1280, "hrnet_w48": 2048}
    assert model.feature == BACKBONE_FEATURE_DIM["hrnet_w48"]
    specs = ref.param_specs(hrnet.HRNET_W48)
    assert sum(int(np.prod(s)) for n, s, _ in specs if "running_" not in n) == 75_420_864


def test_the_seeded_draw_keeps_every_stage_near_the_stem_at_published_widths():
    # one 256 x 256 crop through the float32 reference: every stream's RMS
    # within 0.1 to 10 times the stem's, so a dropped path or residual moves
    # the feature by a share of it (readings 0.59 to 6.8 over three seeds)
    w = _weights(seed=5, sizes=hrnet.HRNET_W48)
    rms = {}

    def tap(name, streams):
        rms[name] = [float(s.pow(2).mean().sqrt()) for s in streams]

    with torch.no_grad():
        feats = ref.forward(w, _frames(n=1, side=256), hrnet.HRNET_W48, tap=tap)
    assert feats.shape == (1, 2048) and torch.isfinite(feats).all()
    assert list(rms) == ["stem", "stage1", "stage2", "stage3", "stage4", "head"]
    assert [len(v) for v in rms.values()] == [1, 1, 2, 3, 4, 1]
    stem = rms["stem"][0]
    for name, values in rms.items():
        for v in values:
            assert 0.1 * stem <= v <= 10 * stem, (name, v / stem)


# ------------------------------------------------------------- extraction

@pytest.fixture
def tiny_hrnet(monkeypatch, tmp_path):
    """`--backbone hrnet_w48` at the tiny widths, from a file of CLIFF's
    layout (the backbone under `encoder.`)."""
    monkeypatch.setattr(hrnet, "HRNET_W48", dict(TINY))
    path = tmp_path / "hrnet.pt"
    torch.save({"encoder." + k: v for k, v in _weights().items()}, path)
    return str(path)


def _extract(root, weights, dataset, device="cpu", **kw):
    args = dict(seq_len=8, resize=128, batch_size=2, num_workers=2, augment=True,
                shard_size=2, shuffle_pool=100, shuffle_seed=1, backbone="hrnet_w48",
                weights=weights)
    args.update(kw)
    return pipeline.run_extract(ExtractConfig(out=str(root), **args), dataset=dataset,
                                device=device)


def test_run_extract_hrnet_both_schedulers_agree(tmp_path, tiny_hrnet):
    ds = FakeOverlapDataset(smooth=False)
    kw = dict(crop_scope="clip", jitter_key="clip")
    got = _extract(tmp_path / "dedup", tiny_hrnet, ds, **kw)
    _extract(tmp_path / "clip", tiny_hrnet, ds, dedup=False, **kw)
    assert got["n_clips"] == len(ds) and got["backbone_frames"] > 0
    # bfloat16 rows in other batches: the per-row arithmetic is the same
    _same_store(tmp_path / "dedup", tmp_path / "clip", 1e-6)
    feats = _store(tmp_path / "dedup")[0]
    assert feats.shape[-1] == TINY["feature"] == \
        FeatureClipDataset(tmp_path / "dedup").feature_dim


def test_run_extract_hrnet_rows_are_the_reference_features(tmp_path, tiny_hrnet):
    # every stored orig row is the reference's feature of its frame's crop
    ds = FakeOverlapDataset(n_videos=1, smooth=True)
    before = profiling.totals()
    summary = _extract(tmp_path / "s", tiny_hrnet, ds, save_fp16=True)
    counts = profiling.since(before)["counts"]
    assert counts["h36x.hrnet.frames"] == summary["backbone_frames"]
    assert counts["h36x.hrnet.fuse_paths"] == 20 * counts["h36x.extract.dispatches"]
    feats, _, _, _, meta = _store(tmp_path / "s")
    w, worst = _weights(), 0.0
    for row, m in enumerate(meta):
        if m["aug"] != "orig":
            continue
        frames, _, _, _, _ = ds[[c.start for c in ds.clips].index(m["start"])]
        crops = pipeline.crop_resize_frames(np.asarray(frames), m["box"], 128)
        want = ref.forward(w, torch.from_numpy(crops), TINY)
        worst = max(worst, _rel(torch.from_numpy(feats[row].astype(np.float32)), want))
    assert 0 < worst <= BF16_REL


def test_run_extract_hrnet_over_two_local_devices(tmp_path, tiny_hrnet, monkeypatch,
                                                  capsys):
    from h36x_torch.utils import runtime

    ds = FakeOverlapDataset(n_videos=1, smooth=True)
    for name, n in (("one", 1), ("two", 2)):
        for module in (pipeline, runtime):
            monkeypatch.setattr(module, "local_devices",
                                lambda device, n=n: [torch.device("cpu")] * n)
        _extract(tmp_path / name, tiny_hrnet, ds, batch_size=1, num_workers=1)
    assert "Extraction over 2 devices (data-parallel backbone)" in capsys.readouterr().out
    _same_store(tmp_path / "one", tmp_path / "two", 1e-6)


def test_phd_trains_on_the_hrnet_store(tmp_path, tiny_hrnet):
    from h36x_torch.cli.train import main as train_main

    _extract(tmp_path / "s", tiny_hrnet, FakeOverlapDataset(smooth=True))
    args = ["--train-root", str(tmp_path / "s"), "--train-subjects", "1",
            "--val-subjects", "2", "--outdir", str(tmp_path / "runs"), "--device", "cpu",
            "--model.latent-dim", "64", "--model.num-blocks", "1", "--model.groups", "8",
            "--data.seq-len", "8", "--optim.batch-size", "4", "--optim.epochs", "1",
            "--model.feature-dim", "64"]
    _, best = train_main(args)
    assert np.isfinite(best)
    rows = [json.loads(x) for x in
            (tmp_path / "runs" / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and np.isfinite(rows[0]["train_loss"])


def test_cli_extract_hrnet_then_cli_train(ingested_tree, tiny_hrnet, tmp_path):  # noqa: F811
    """The entry points a user calls, on the mp4 tree of
    tests/test_full_pipeline.py: `cli.extract --backbone hrnet_w48` writes a
    verified store of the backbone's width that `cli.train` trains on."""
    from h36x_torch.cli.extract import main as extract_main
    from h36x_torch.cli.train import main as train_main

    out = tmp_path / "features"
    summary = extract_main([
        "--root", str(ingested_tree), "--out", str(out), "--seq-len", "8",
        "--stride", "4", "--resize", "128", "--batch-size", "2", "--num-workers", "2",
        "--augment", "true", "--shard-size", "2", "--subjects", "1", "5", "9",
        "--backbone", "hrnet_w48", "--weights", tiny_hrnet, "--verify-after", "true",
        "--device", "cpu"])
    assert summary["n_clips"] == 12 and summary["backbone_frames"] > 0
    assert FeatureClipDataset(out).feature_dim == TINY["feature"]
    _, best = train_main([
        "--train-root", str(out), "--train-subjects", "1", "--val-subjects", "5",
        "--outdir", str(tmp_path / "runs"), "--device", "cpu", "--model.feature-dim", "64",
        "--model.latent-dim", "64", "--model.num-blocks", "1", "--model.groups", "8",
        "--data.seq-len", "8", "--optim.batch-size", "4", "--optim.epochs", "1"])
    assert np.isfinite(best)


def test_engine_opt_and_other_crop_sizes_are_refused(tiny_hrnet):
    with pytest.raises(ValueError, match="--engine opt is ResNet-50's; --backbone hrnet_w48"):
        pipeline.validate_extract_config(ExtractConfig(backbone="hrnet_w48", engine="opt"))
    pipeline.validate_extract_config(ExtractConfig(backbone="hrnet_w48"))
    with pytest.raises(ValueError, match="--backbone hrnet_w48 reads 128-pixel crops; "
                                         "--resize is 224"):
        pipeline._load_backbone(ExtractConfig(backbone="hrnet_w48"), "cpu")
    with pytest.raises(ValueError, match="the HRNet backbone has no --engine 'opt'"):
        pipeline.make_feature_fn(_port(_weights()), engine="opt")


def test_load_backbone_builds_hrnet(tiny_hrnet, capsys):
    model = pipeline._load_backbone(ExtractConfig(backbone="hrnet_w48", resize=128,
                                                  weights=tiny_hrnet), "cpu")
    assert isinstance(model, hrnet.HRNet) and model.dtype == torch.bfloat16
    assert next(model.parameters()).device.type == "cpu"
    assert torch.equal(model.final_layer[0].bias.float(),
                       _weights()["final_layer.0.bias"].bfloat16().float())
    drawn = pipeline._load_backbone(ExtractConfig(backbone="hrnet_w48", resize=128), "cpu")
    assert isinstance(drawn, hrnet.HRNet)
    assert all(torch.isfinite(t.float()).all() for t in drawn.state_dict().values())
    out = capsys.readouterr().out
    assert f"Loaded HRNet-W48 weights from {tiny_hrnet}" in out
    assert "randomly initialized HRNet-W48" in out
    feats = pipeline.make_feature_fn(drawn)(_frames(n=2))
    assert feats.shape == (2, 64) and torch.isfinite(feats).all()


def test_one_table_names_every_backbone():
    assert set(BACKBONES) == set(BACKBONE_FEATURE_DIM) == {"resnet50", "vit_h", "hrnet_w48"}
    assert pipeline.ENGINES == ("flax", "opt")
    for name, spec in BACKBONES.items():
        assert (name == "resnet50") == ("opt" in spec.engines)
        assert store.backbone_provenance(ExtractConfig(backbone=name)) == (
            {} if name == "resnet50" else {"backbone": name})
    with pytest.raises(ValueError, match=re.escape("--backbone must be resnet50|vit_h|hrnet_w48")):
        pipeline.validate_extract_config(ExtractConfig(backbone="hrnet_w32"))
