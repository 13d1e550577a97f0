"""The plain reference and the frozen draw rules against the port's own
plain path on the CPU, at tiny sizes (the tests may import both; the
reference imports nothing of the port)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import rules, synth
from portbench.reference import phd as ref_phd
from portbench.reference import resnet50 as ref_resnet
from portbench.tests.conftest import TINY_PHD


def _phd_cfg():
    from portbench import harness

    return {**harness.load_json(harness.HERE / "configs" / "phd.json"), **TINY_PHD}


def _model(cfg, w):
    from h36x_torch.cli.common import build_model_from_arch

    model = build_model_from_arch({k: cfg[k] for k in (
        "latent_dim", "feature_dim", "joints_num", "num_blocks", "ar_num_blocks", "groups",
        "kernel_size", "regressor_iters", "regressor_hidden")}, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w[name])
    return model


def test_phd_forward_matches_the_ports_plain_forward():
    cfg = _phd_cfg()
    w = synth.phd_weights(cfg, 11, "cpu")
    feats = synth.clip_bank(cfg, 11, 3)
    got = _model(cfg, w)(feats, use_kernels=False)[2]
    torch.testing.assert_close(ref_phd.forward(w, feats, cfg), got, rtol=1e-5, atol=1e-6)


def test_phd_train_forward_with_dropout_matches_under_the_frozen_mask_rule():
    from h36x_torch.infer import phd_forward_train_fused
    from h36x_torch.models.phd import param_tree

    cfg = _phd_cfg()
    w = synth.phd_weights(cfg, 12, "cpu")
    feats = synth.clip_bank(cfg, 12, 4)
    model = _model(cfg, w)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    _, got = phd_forward_train_fused(param_tree(model), feats, g1, dropout=0.5,
                                     joints_num=17, groups=cfg["groups"], use_kernels=False)
    ref = ref_phd.forward(w, feats, cfg, mask=lambda s: rules.dropout_mask(s, 0.5, g2, "cpu"))
    torch.testing.assert_close(ref, got.detach(), rtol=1e-5, atol=1e-6)


def test_dropout_rule_is_the_ports():
    from h36x_torch.infer import dropout_mask

    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    like = torch.zeros(1)
    for shape in ((4, 8, 16), (32, 64)):
        assert torch.equal(dropout_mask(shape, 0.5, g1, like),
                           rules.dropout_mask(shape, 0.5, g2, "cpu"))


def test_sampler_rule_is_the_ports():
    from h36x_torch.data.sampler import MixedShardBatchSampler

    class Store:
        def __init__(self):
            self.ids = [i // 40 for i in range(200)]

        def __len__(self):
            return len(self.ids)

        def shard_id_of(self, i):
            return self.ids[i]

    store = Store()
    sampler = MixedShardBatchSampler(store, 16, shuffle=True, drop_last=True, seed=2**40 + 3)
    buckets: dict = {}
    for i in range(len(store)):
        buckets.setdefault(store.ids[i], []).append(i)
    for epoch in (0, 3):
        sampler.set_epoch(epoch)
        assert list(sampler) == list(rules.sampler_batches(buckets, 16, 4, 2**40 + 3 + epoch))


def test_adamw_reference_follows_the_ports_within_rounding():
    from h36x_torch.train.state import AdamW

    torch.manual_seed(0)
    p = torch.nn.Parameter(torch.randn(50))
    ref = {"p": p.detach().clone()}
    opt = AdamW([p], lr=1e-2, weight_decay=1e-2)
    radam = ref_phd.AdamW(ref, ["p"], 1e-2, 1e-2)
    for _ in range(3):
        g = torch.randn(50)
        p.grad = g.clone()
        opt.step()
        radam.step({"p": g})
    torch.testing.assert_close(ref["p"], p.detach(), rtol=1e-5, atol=1e-6)


def test_resnet50_reference_matches_the_ports_float32_module():
    from h36x_torch.models.resnet import ResNet50, load_torchvision

    w = ref_resnet.make_weights(torch.Generator().manual_seed(3), "cpu")
    model = load_torchvision(ResNet50(torch.float32, device="cpu"), w)
    frames = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(4))
    from h36x_torch.ops.preprocess import imagenet_normalize

    with torch.no_grad():
        got = model(imagenet_normalize(frames.float() / 255.0))
        ref = ref_resnet.forward(w, rules.normalize(frames))
    torch.testing.assert_close(ref, got, rtol=1e-4, atol=1e-4)


def test_crop_box_and_crop_resize_are_the_ports():
    from h36x_torch.extract.pipeline import crop_resize_frames
    from h36x_torch.geometry.crop import compute_square_crop_from_2d

    for seed in range(4):
        j2d, _ = synth.video_joints(seed, 0, 30, 1000)
        assert rules.square_crop(j2d, 1000, 1000) == tuple(
            int(v) for v in compute_square_crop_from_2d(j2d, 1000, 1000, scale=1.6))
    frames = synth.video_frames(5, 0, 3, 300, "cpu")
    box = (20, 37, 211, 211)
    got = torch.from_numpy(crop_resize_frames(frames.numpy(), np.array(box), 64))
    diff = (rules.crop_resize(frames, box, 64).int() - got.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 0.01


def test_jitter_rules_are_the_ports():
    from h36x_torch.data.augment import jitter_u8, sample_jitter_params

    for seed in range(6):
        a = rules.jitter_params(rules.video_jitter_rng(seed, 2))
        b = sample_jitter_params(np.random.default_rng(seed * 2_000_003 + 2))
        assert list(a[0]) == list(b[0]) and a[1:] == b[1:]
        frames = synth.video_frames(seed, 0, 2, 48, "cpu")
        got = torch.from_numpy(jitter_u8(frames.numpy(), b))
        diff = (rules.jitter(frames, a).int() - got.int()).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 0.01
