"""The ViT-H backbone (h36x_torch/models/vit.py) on the CPU at a tiny size
(width 64, depth 2, 4 heads, MLP 256, patch 8, 32 x 32 crops read as
32 x 24): against the plain reference of tests/vit_reference.py on seeded
weights, its column slice and flip, its state_dict loader, and
`run_extract(backbone='vit_h')` on both schedulers and over two local
devices, with PHD trained from the store it writes."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from h36x_torch.config import BACKBONE_FEATURE_DIM, ExtractConfig
from h36x_torch.data.features import FeatureClipDataset
from h36x_torch.extract import pipeline, store
from h36x_torch.models import vit
from h36x_torch.models.resnet import ResNet50
from h36x_torch.utils import profiling
from tests import vit_reference as ref
from tests.test_dedup import _PROJ, FakeOverlapDataset, fake_backbone  # noqa: F401
from tests.test_full_pipeline import ingested_tree  # noqa: F401

TINY = dict(img_size=(32, 24), patch=8, padding=2, dim=64, depth=2, heads=4, mlp=256,
            eps=1e-6)
# timm's std (0.02) is set for widths near ViT-H's 1280; scaled as
# 1 / sqrt(width) it keeps the tiny model's branches at their full-width
# share of the residual stream (test_branches_are_a_tenth_of_the_stream...)
TINY_STD = 0.02 * (1280 / 64) ** 0.5
# float32 against float32: the same sums in another order (SDPA's against
# the explicit softmax, the conv's against the reference's)
F32_REL = 1e-5
# bfloat16 weights and activations against float32: about 2^-8 a rounding,
# a residual stream rounded at each of 2 x depth adds and LayerNorm's
# output rounded; readings 5.4e-3 to 6.7e-3 over five seeds. A skipped
# block reads 0.61 and the whole crop read 1.25 (test_faults_read_far_above...)
BF16_REL = 2e-2


def _weights(seed=3, cfg=TINY, std=TINY_STD):
    return ref.make_weights(cfg, torch.Generator().manual_seed(seed), std=std)


def _frames(n=12, side=32, seed=4):
    return torch.randint(0, 256, (n, side, side, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))


def _port(w, dtype=torch.float32, cfg=TINY):
    return vit.load_vitpose(vit.ViT(dtype=dtype, **cfg), w, "cpu")


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


@pytest.mark.parametrize("seed", [3, 11, 23])
def test_bfloat16_port_matches_the_reference_within_its_rounding(seed):
    w, x = _weights(seed), _frames(seed=seed + 1)
    model = _port(w, torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    got = _run(model, x)
    assert got.dtype == torch.float32
    assert _rel(got, ref.forward(w, x, TINY)) <= BF16_REL


def test_faults_read_far_above_the_bfloat16_tolerance():
    w, x = _weights(), _frames()
    want = ref.forward(w, x, TINY)
    one_block = dict(TINY, depth=1)
    skipped = {k: v for k, v in w.items() if not k.startswith("blocks.1.")}
    assert _rel(ref.forward(skipped, x, one_block), want) > 10 * BF16_REL
    # the whole crop read where the middle columns should be
    wide = dict(TINY, img_size=(32, 32))
    w_wide = dict(w, pos_embed=torch.cat([w["pos_embed"], w["pos_embed"][:, 1:5]], 1))
    assert _rel(ref.forward(w_wide, x, wide), want) > 10 * BF16_REL


def test_only_the_middle_columns_are_read():
    model, x = _port(_weights()), _frames()
    assert model.columns(32) == slice(4, 28)
    y = x.clone()
    y[:, :, :4] = 0
    y[:, :, 28:] = 255
    torch.testing.assert_close(_run(model, y), _run(model, x), rtol=0, atol=0)
    z = x.clone()
    z[:, :, 4] = 255 - z[:, :, 4]
    assert _rel(_run(model, z), _run(model, x)) > 1e-3
    with pytest.raises(ValueError, match="--resize 32"):
        _run(model, _frames(side=28))


def test_the_flip_commutes_with_the_symmetric_slice():
    model, x = _port(_weights()), _frames()
    cols = model.columns(32)
    flipped_then_sliced = x.flip(2)[:, :, cols]
    sliced_then_flipped = x[:, :, cols].flip(2)
    assert torch.equal(flipped_then_sliced, sliced_then_flipped)
    y = torch.zeros_like(x)
    y[:, :, cols] = sliced_then_flipped
    torch.testing.assert_close(_run(model, x.flip(2)), _run(model, y), rtol=0, atol=0)


@pytest.mark.parametrize("prefix", ["", "backbone."])
def test_state_dict_round_trip(prefix):
    w = _weights()
    model = _port(w)
    sd = {prefix + k: v.clone() for k, v in model.state_dict().items()}
    if prefix:  # a ViTPose / HMR 2.0 checkpoint: heads beside the backbone
        sd["keypoint_head.final_layer.weight"] = torch.zeros(17, 64, 1, 1)
        sd["smpl_head.decpose.bias"] = torch.zeros(144)
    again = vit.load_vitpose(vit.ViT(dtype=torch.float32, **TINY), sd, "cpu")
    assert again.state_dict().keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    assert all(not p.requires_grad and p.device.type == "cpu" for p in again.parameters())
    assert set(w) == set(model.state_dict())


def test_loader_refuses_another_layout(tmp_path):
    w = _weights()
    with pytest.raises(KeyError, match="missing"):
        vit.load_vitpose(vit.ViT(**TINY), {k: v for k, v in w.items() if "fc2" not in k},
                         "cpu")
    with pytest.raises(KeyError, match="other shapes"):
        vit.load_vitpose(vit.ViT(**dict(TINY, mlp=128)), w, "cpu")
    path = tmp_path / "w.pt"
    torch.save({"state_dict": {"backbone." + k: v for k, v in w.items()}}, path)
    model = vit.load_vitpose_file(vit.ViT(dtype=torch.float32, **TINY), path, "cpu")
    assert torch.equal(model.pos_embed, w["pos_embed"])


def _branch_shares(w, x, cfg):
    """(attention, MLP) branch norm over the residual stream's, a block."""
    model = _port(w, cfg=cfg)
    out = []
    with torch.inference_mode():
        h = x[:, :, model.columns(x.shape[1])]
        h = (h.float() / 255.0 - torch.tensor(ref.MEAN)) / torch.tensor(ref.STD)
        h = model.patch_embed.proj(h.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        h = h + model.pos_embed[:, 1:] + model.pos_embed[:, :1]
        for blk in model.blocks:
            a = blk.attn(blk.norm1(h))
            share_a = float(a.norm() / h.norm())
            h = h + a
            m = blk.mlp(blk.norm2(h))
            out.append((share_a, float(m.norm() / h.norm())))
            h = h + m
    return out


def test_branches_are_a_tenth_of_the_stream_under_the_seeded_init():
    # a skipped branch or block then moves the feature by far more than
    # bfloat16's rounding
    for share_a, share_m in _branch_shares(_weights(), _frames(), TINY):
        assert share_a >= 0.10 and share_m >= 0.10, (share_a, share_m)


def test_published_width_keeps_the_branches_under_timms_std():
    # two blocks of ViT-H's widths on two 256 x 256 crops, at timm's 0.02
    cfg = dict(vit.VIT_H, depth=2)
    w = ref.make_weights(cfg, torch.Generator().manual_seed(5))
    for share_a, share_m in _branch_shares(w, _frames(n=2, side=256), cfg):
        assert share_a >= 0.10 and share_m >= 0.10, (share_a, share_m)


def test_spans_and_the_token_counter_of_a_dispatch():
    model, x = _port(_weights(), torch.bfloat16), _frames(n=5)
    before = profiling.totals()
    _run(model, x)
    gained = profiling.since(before)
    calls = {k: c for k, (_, c) in gained["host_s"].items() if k.startswith("h36x.vit.")}
    assert calls == {"h36x.vit.embed": 1, "h36x.vit.attention": TINY["depth"],
                     "h36x.vit.mlp": TINY["depth"], "h36x.vit.head": 1}
    assert calls["h36x.vit.attention"] + calls["h36x.vit.mlp"] == 2 * TINY["depth"]
    assert gained["counts"]["h36x.vit.tokens"] == 5 * 12 == 5 * model.tokens


def test_published_sizes_and_widths():
    model = vit.ViT()  # on meta: no weights drawn
    assert model.grid == (16, 12) and model.tokens == 192
    assert next(model.parameters()).device.type == "meta"
    n = sum(p.numel() for p in model.parameters())
    assert 630e6 < n < 634e6, n
    assert BACKBONE_FEATURE_DIM == {"resnet50": 2048, "vit_h": 1280, "hrnet_w48": 2048}
    assert model.dim == BACKBONE_FEATURE_DIM["vit_h"]


# ------------------------------------------------------------- extraction

@pytest.fixture
def tiny_vit_h(monkeypatch, tmp_path):
    """`--backbone vit_h` at the tiny widths, from a ViTPose-layout file."""
    monkeypatch.setattr(vit, "VIT_H", dict(TINY))
    path = tmp_path / "vitpose.pt"
    torch.save({"backbone." + k: v for k, v in _weights().items()}, path)
    return str(path)


def _extract(root, weights, dataset, device="cpu", **kw):
    args = dict(seq_len=8, resize=32, batch_size=2, num_workers=2, augment=True,
                shard_size=2, shuffle_pool=100, shuffle_seed=1, backbone="vit_h",
                weights=weights)
    args.update(kw)
    return pipeline.run_extract(ExtractConfig(out=str(root), **args), dataset=dataset,
                                device=device)


def _store(root):
    ds = FeatureClipDataset(root, augment=True, test_set=True)
    return ds.get_batch(list(range(len(ds))))


def _same_store(a_root, b_root, feat_rel):
    assert (Path(a_root) / "index.json").read_bytes() == \
        (Path(b_root) / "index.json").read_bytes()
    a, b = _store(a_root), _store(b_root)
    for x, y in zip(a[1:4], b[1:4]):
        np.testing.assert_array_equal(x, y)
    assert [m["box"] for m in a[4]] == [m["box"] for m in b[4]]
    fa, fb = a[0].astype(np.float64), b[0].astype(np.float64)
    assert np.isfinite(fb).all() and np.abs(fa).max() > 0
    assert np.linalg.norm(fb - fa) / np.linalg.norm(fa) <= feat_rel


def test_run_extract_vit_h_both_schedulers_agree(tmp_path, tiny_vit_h):

    ds = FakeOverlapDataset(smooth=False)
    kw = dict(crop_scope="clip", jitter_key="clip")
    got = _extract(tmp_path / "dedup", tiny_vit_h, ds, **kw)
    _extract(tmp_path / "clip", tiny_vit_h, ds, dedup=False, **kw)
    assert got["n_clips"] == len(ds) and got["backbone_frames"] > 0
    # bfloat16 rows in other batches: the per-row arithmetic is the same
    _same_store(tmp_path / "dedup", tmp_path / "clip", 1e-6)
    feats = _store(tmp_path / "dedup")[0]
    assert feats.shape[-1] == TINY["dim"] == FeatureClipDataset(tmp_path / "dedup").feature_dim


def test_run_extract_vit_h_rows_are_the_reference_features(tmp_path, tiny_vit_h):
    # every stored orig row is the reference's feature of its frame's crop

    ds = FakeOverlapDataset(n_videos=1, smooth=True)
    _extract(tmp_path / "s", tiny_vit_h, ds, save_fp16=True)
    feats, _, _, _, meta = _store(tmp_path / "s")
    w, worst = _weights(), 0.0
    for row, m in enumerate(meta):
        if m["aug"] != "orig":
            continue
        frames, _, _, _, _ = ds[[c.start for c in ds.clips].index(m["start"])]
        crops = pipeline.crop_resize_frames(np.asarray(frames), m["box"], 32)
        want = ref.forward(w, torch.from_numpy(crops), TINY)
        worst = max(worst, _rel(torch.from_numpy(feats[row].astype(np.float32)), want))
    assert 0 < worst <= BF16_REL


def test_run_extract_vit_h_over_two_local_devices(tmp_path, tiny_vit_h, monkeypatch, capsys):
    from h36x_torch.utils import runtime

    ds = FakeOverlapDataset(n_videos=1, smooth=True)
    for name, n in (("one", 1), ("two", 2)):
        for module in (pipeline, runtime):
            monkeypatch.setattr(module, "local_devices",
                                lambda device, n=n: [torch.device("cpu")] * n)
        _extract(tmp_path / name, tiny_vit_h, ds, batch_size=1, num_workers=1)
    assert "Extraction over 2 devices (data-parallel backbone)" in capsys.readouterr().out
    _same_store(tmp_path / "one", tmp_path / "two", 1e-6)


def test_phd_trains_on_the_vit_h_store_and_refuses_another_width(tmp_path, tiny_vit_h):
    from h36x_torch.cli.train import main as train_main

    _extract(tmp_path / "s", tiny_vit_h, FakeOverlapDataset(smooth=True))
    args = ["--train-root", str(tmp_path / "s"), "--train-subjects", "1",
            "--val-subjects", "2", "--outdir", str(tmp_path / "runs"), "--device", "cpu",
            "--model.latent-dim", "64", "--model.num-blocks", "1", "--model.groups", "8",
            "--data.seq-len", "8", "--optim.batch-size", "4", "--optim.epochs", "1"]
    _, best = train_main(args + ["--model.feature-dim", "64"])
    assert np.isfinite(best)
    rows = [json.loads(x) for x in
            (tmp_path / "runs" / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and np.isfinite(rows[0]["train_loss"])
    with pytest.raises(ValueError, match="64-wide features but --model.feature-dim is 2048"):
        train_main(args + ["--outdir", str(tmp_path / "runs2")])


def test_cli_extract_vit_h_then_cli_train(ingested_tree, tiny_vit_h, tmp_path):  # noqa: F811
    """The entry points a user calls, on the mp4 tree of
    tests/test_full_pipeline.py: `cli.extract --backbone vit_h` writes a
    verified store of the backbone's width that `cli.train` trains on."""
    from h36x_torch.cli.extract import main as extract_main
    from h36x_torch.cli.train import main as train_main

    out = tmp_path / "features"
    summary = extract_main([
        "--root", str(ingested_tree), "--out", str(out), "--seq-len", "8",
        "--stride", "4", "--resize", "32", "--batch-size", "2", "--num-workers", "2",
        "--augment", "true", "--shard-size", "2", "--subjects", "1", "5", "9",
        "--backbone", "vit_h", "--weights", tiny_vit_h, "--verify-after", "true",
        "--device", "cpu"])
    assert summary["n_clips"] == 12 and summary["backbone_frames"] > 0
    assert FeatureClipDataset(out).feature_dim == TINY["dim"]
    _, best = train_main([
        "--train-root", str(out), "--train-subjects", "1", "--val-subjects", "5",
        "--outdir", str(tmp_path / "runs"), "--device", "cpu", "--model.feature-dim", "64",
        "--model.latent-dim", "64", "--model.num-blocks", "1", "--model.groups", "8",
        "--data.seq-len", "8", "--optim.batch-size", "4", "--optim.epochs", "1"])
    assert np.isfinite(best)


def test_engine_opt_and_other_crop_sizes_are_refused(tmp_path, tiny_vit_h):
    with pytest.raises(ValueError, match="--engine opt is ResNet-50's"):
        pipeline.validate_extract_config(ExtractConfig(backbone="vit_h", engine="opt"))
    with pytest.raises(ValueError, match="--backbone must be"):
        pipeline.validate_extract_config(ExtractConfig(backbone="vit_l"))
    pipeline.validate_extract_config(ExtractConfig(backbone="vit_h"))
    with pytest.raises(ValueError, match="--resize is 16"):
        pipeline._load_backbone(ExtractConfig(backbone="vit_h", resize=16), "cpu")
    with pytest.raises(ValueError, match="no --engine 'opt'"):
        pipeline.make_feature_fn(_port(_weights()), engine="opt")


def test_load_backbone_builds_each_backbone(tmp_path, tiny_vit_h):
    model = pipeline._load_backbone(ExtractConfig(backbone="vit_h", resize=32,
                                                  weights=tiny_vit_h), "cpu")
    assert isinstance(model, vit.ViT) and model.dtype == torch.bfloat16
    assert next(model.parameters()).device.type == "cpu"
    drawn = pipeline._load_backbone(ExtractConfig(backbone="vit_h", resize=32), "cpu")
    assert isinstance(drawn, vit.ViT) and torch.isfinite(drawn.pos_embed.float()).all()
    assert isinstance(pipeline._load_backbone(ExtractConfig(), "cpu"), ResNet50)


@pytest.mark.parametrize("dedup", [True, False])
def test_resnet50_stores_stay_byte_identical(tmp_path, dedup, fake_backbone,  # noqa: F811
                                             monkeypatch):
    """`--backbone resnet50`, said or left to its default, writes the store
    h36x writes (the port's ResNet-50 path as it was), progress files
    included: a resnet50 run records no backbone, so a store begun before
    the option existed resumes. `--backbone vit_h` and `hrnet_w48` write the
    same bytes from the same features: the backbone table changes the model
    alone."""
    import h36x.extract.pipeline as jax_pipeline
    from h36x.config import ExtractConfig as JaxExtractConfig

    from tests.test_torch_extract import _store_files

    def make(model, mesh=None, engine="flax"):
        def fn(frames):
            flat = frames.numpy().reshape(frames.shape[0], -1).astype(np.float64)
            return torch.from_numpy(np.tile(np.asarray(flat @ _PROJ, np.float32),
                                            (1, 2048 // 64)))
        return fn

    monkeypatch.setattr(pipeline, "_load_backbone", lambda cfg, device: None)
    monkeypatch.setattr(pipeline, "make_feature_fn", make)
    ds = FakeOverlapDataset(smooth=False)
    kw = dict(seq_len=8, resize=16, batch_size=2, num_workers=2, augment=True,
              shard_size=3, shuffle_pool=100, shuffle_seed=1, dedup=dedup)
    jax_pipeline.run_extract(JaxExtractConfig(out=str(tmp_path / "h36x"), **kw), dataset=ds)
    pipeline.run_extract(ExtractConfig(out=str(tmp_path / "said"), backbone="resnet50",
                                       **kw), dataset=ds, device="cpu")
    pipeline.run_extract(ExtractConfig(out=str(tmp_path / "default"), **kw), dataset=ds,
                         device="cpu")
    for backbone in ("vit_h", "hrnet_w48"):
        pipeline.run_extract(ExtractConfig(out=str(tmp_path / backbone), backbone=backbone,
                                           **kw), dataset=ds, device="cpu")
    want = _store_files(tmp_path / "h36x")
    assert _store_files(tmp_path / "said") == want == _store_files(tmp_path / "default")
    assert _store_files(tmp_path / "vit_h") == want == _store_files(tmp_path / "hrnet_w48")
    assert store.backbone_provenance(ExtractConfig()) == {}
    assert store.backbone_provenance(ExtractConfig(backbone="vit_h")) == {
        "backbone": "vit_h"}
    assert store.backbone_provenance(ExtractConfig(backbone="hrnet_w48")) == {
        "backbone": "hrnet_w48"}

