"""The operation and byte counters against counts made by hand at small
shapes."""

from __future__ import annotations

import pytest

from portbench import roofline as r

CFG = dict(seq_len=2, feature_dim=4, latent_dim=2, kernel_size=3, regressor_hidden=3,
           joints_num=1, regressor_iters=2, num_blocks=1, dropout=0.5)


def test_phd_forward_by_hand():
    units = {u.name: u for u in r.phd_forward_units(CFG, 1)}
    # N = 2 rows; input_proj 2*N*F*D = 32 ops; bytes (N*F + F*D + D + N*D) * 4
    assert units["input_proj"].flops == 2 * 2 * 4 * 2
    assert units["input_proj"].nbytes == (8 + 8 + 2 + 4) * 4
    # a half: 2*N*K*D*D = 48; x, W (K*D*D), conv bias, GN scale+bias, out
    h1 = units["f_movie.block0.half1"]
    assert h1.flops == 2 * 2 * 3 * 2 * 2
    assert h1.nbytes == (4 + 12 + 2 + 4 + 4) * 4
    assert units["f_movie.block0.half2"].nbytes == h1.nbytes + 4 * 4  # + residual
    # regressor, out 3, hidden 3: per iter 2*N*((D+3)*H + H*H + H*3) = 2*2*(15+9+9)
    assert units["f_3D"].flops == 2 * 2 * 2 * (15 + 9 + 9)
    weights = 5 * 3 + 3 + 9 + 3 + 9 + 3
    assert units["f_3D"].nbytes == (4 + weights + 6) * 4
    assert r.total_flops(units.values()) == 32 + 48 + 48 + 264


def test_phd_train_step_by_hand():
    units = {u.name: u for u in r.phd_train_step_units(CFG, 1)}
    fwd = {u.name: u for u in r.phd_forward_units(CFG, 1, dropout_masks=True)}
    assert units["input_proj.bwd"].flops == fwd["input_proj"].flops  # weights only
    assert units["f_movie.block0.half1.bwd"].flops == 2 * fwd["f_movie.block0.half1"].flops
    assert units["f_3D.bwd"].flops == 2 * fwd["f_3D"].flops
    # the mask is read by the second half, forward and backward
    assert fwd["f_movie.block0.half2"].nbytes == (4 + 12 + 2 + 4 + 4 + 4 + 4) * 4
    params = (4 * 2 + 2) + 2 * (12 + 2 + 4) + (5 * 3 + 3 + 9 + 3 + 9 + 3)
    assert r.phd_trainable_params(CFG) == params
    assert units["adamw"].nbytes == 28 * params and units["adamw"].flops == 0


def test_phd_published_widths():
    cfg = dict(seq_len=40, feature_dim=2048, latent_dim=1024, kernel_size=3,
               regressor_hidden=1024, joints_num=17, regressor_iters=3, num_blocks=2,
               dropout=0.5)
    n = 32 * 40
    fwd = r.total_flops(r.phd_forward_units(cfg, 32))
    assert fwd == 2 * n * (2048 * 1024 + 4 * 3 * 1024 * 1024
                           + 3 * ((1024 + 51) * 1024 + 1024 * 1024 + 1024 * 51))
    assert fwd == pytest.approx(54.49e9, rel=1e-3)


def test_resnet50_by_hand():
    units = {u.name: u for u in r.resnet50_units(1)}
    assert units["stem"].flops == 2 * 112 * 112 * 7 * 7 * 3 * 64
    assert units["stem"].nbytes == 224 * 224 * 3 + (7 * 7 * 3 * 64 + 64) * 2 + 56 * 56 * 64 * 2
    # layer1.1: 1x1 256->64, 3x3 64->64, 1x1 64->256 at 56x56
    b = units["layer1.1.bottleneck"]
    assert b.flops == 2 * 56 * 56 * (256 * 64 + 9 * 64 * 64 + 64 * 256)
    assert b.nbytes == 2 * (56 * 56 * 256 * 2) + (256 * 64 + 9 * 64 * 64 + 64 * 256 + 6 * 64) * 2
    # layer2.0: conv1 at 56x56 (256->128), stride on the 3x3, projection at 28x28
    t = units["layer2.0.transition"]
    assert t.flops == 2 * (56 * 56 * 256 * 128 + 28 * 28 * (9 * 128 * 128 + 128 * 512
                                                              + 256 * 512))
    # 4.09 G multiply-adds a frame, the published count
    assert r.total_flops(units.values()) == pytest.approx(8.17e9, rel=1e-3)
    assert len(units) == 1 + 16 + 1


def test_resnet50_weights_are_read_once_a_dispatch():
    one = {u.name: u for u in r.resnet50_units(1)}
    two = {u.name: u for u in r.resnet50_units(2)}
    # the stem at 2 frames: 2 frames in and out, its weights once
    assert two["stem"].nbytes == (2 * 224 * 224 * 3 + (7 * 7 * 3 * 64 + 64) * 2
                                  + 2 * 56 * 56 * 64 * 2)
    weights = (2048 * 512 + 9 * 512 * 512 + 512 * 2048 + 6 * 512) * 2  # layer4.1
    assert two["layer4.1.bottleneck"].nbytes == 2 * one["layer4.1.bottleneck"].nbytes - weights
    for name, u in one.items():
        assert two[name].flops == 2 * u.flops


def test_phd_weights_are_read_once_a_batch():
    one = {u.name: u for u in r.phd_forward_units(CFG, 1)}
    two = {u.name: u for u in r.phd_forward_units(CFG, 2)}
    # input_proj at 2 clips (4 rows): rows in and out twice, W and b once
    assert two["input_proj"].nbytes == (16 + 8 + 2 + 8) * 4
    weights = 5 * 3 + 3 + 9 + 3 + 9 + 3
    assert two["f_3D"].nbytes == 2 * one["f_3D"].nbytes - weights * 4


def test_batches_sum_batch_by_batch():
    assert r.batch_sizes(7, 3) == {3: 2, 1: 1}
    assert r.batch_sizes(6, 3) == {3: 2}
    assert r.batch_sizes(2, 3) == {2: 1}
    flops, bound = r.over_batches(r.resnet50_units, {3: 2, 1: 1})
    assert flops == pytest.approx(7 * r.total_flops(r.resnet50_units(1)))
    assert bound == pytest.approx(2 * r.total_bound_s(r.resnet50_units(3))
                                  + r.total_bound_s(r.resnet50_units(1)))
    # a frame's least time falls as a dispatch grows: the weights spread
    per_frame = [r.total_bound_s(r.resnet50_units(n)) / n for n in (1, 8, 3840)]
    assert per_frame[0] > per_frame[1] > per_frame[2]


def test_bound_is_the_larger_of_operations_and_bytes():
    u = r.Unit("x", r.PEAK_FLOPS, r.PEAK_BYTES * 2)
    assert u.bound_s == pytest.approx(2.0)
    assert r.Unit("y", r.PEAK_FLOPS * 3, 0).bound_s == pytest.approx(3.0)
