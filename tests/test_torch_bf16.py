"""`--model.dtype bfloat16` in h36x_torch against h36x's bf16 compute on the
CPU: the same flax params (h36x's model.init, carried across by
params_from_flax) through the port's PHDFor3DJoints(dtype=torch.bfloat16)
and h36x's PHDFor3DJoints(dtype=jnp.bfloat16). h36x's own bf16 bounds
(tests/test_train_step.py::TestMixedPrecision): a bf16 run's first loss
within rtol 2e-2 of f32's, the loss falling over 20 steps."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from h36x.models.phd import PHDFor3DJoints as FlaxPHD
from h36x.train import losses as jax_losses
from h36x.train.state import create_train_state
from h36x.train.step import make_future_train_step as jax_make_future_train_step
from h36x.train.step import make_weighted_eval_step as jax_make_weighted_eval_step
from h36x_torch.cli.train import main as train_main
from h36x_torch.config import TrainConfig
from h36x_torch import infer
from h36x_torch.infer import phd_forward_fused
from h36x_torch.models.phd import PHDFor3DJoints, param_tree, params_from_flax
from h36x_torch.train.loop import build_model, check_supported
from h36x_torch.train.state import make_optimizer
from h36x_torch.train.step import (
    grads_and_metrics,
    make_future_train_step,
    make_train_step,
    make_weighted_eval_step,
)
from tests.helpers import make_synthetic_store

T = 6
SMALL = dict(latent_dim=64, feature_dim=32, number_blocks=1, groups=8)
BF = torch.bfloat16
OUTPUTS = ("phi", "phi_hat", "joints_phi", "joints_hat")
# Bounds on mean |port bf16 - h36x bf16| per output of the eval forward
# (predict_future on), set from readings of _mean_gaps: params and
# features from seeds 0-4, batch 16.
#   The port: phi and phi_hat equal h36x's exactly; joints_phi 3.5e-4 to
#   3.8e-4, joints_hat 4.2e-4 to 4.9e-4 (the regressor's bf16 products
#   round in other orders: about one bf16 ulp on a share of the joints).
#   Controls that compute otherwise (CONTROLS): a float32 engine with its
#   outputs cast to bf16, phi 2.3e-3 and up; GroupNorm statistics and
#   output in bf16, phi 1.7e-3 and up; the regressor in float32,
#   joints_phi 5.1e-4 and up, joints_hat 6.1e-4 and up.
# Each bound lies between the port's largest reading and the controls'
# smallest.
MEAN_TOL = {"phi": 5e-4, "phi_hat": 5e-4, "joints_phi": 4.4e-4,
            "joints_hat": 5.5e-4}
GAP_BATCH = 16


def _t(a):
    return torch.from_numpy(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _seed_params(seed):
    """h36x's init of the small model from `seed`, as numpy arrays."""
    model = FlaxPHD(**SMALL, dropout=0.0)
    params = jax.jit(model.init)(jax.random.key(seed), jnp.zeros((2, T, 32)))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def flax_params():
    return _seed_params(0)


def _port(params, dtype=BF, **kw):
    model = PHDFor3DJoints(**SMALL, dropout=0.0, device="cpu", dtype=dtype, **kw)
    model.load_state_dict(params_from_flax(params))
    return model


def _batch(rng, b=4):
    return (rng.normal(size=(b, T, 32)).astype(np.float32),
            (rng.normal(size=(b, T, 17, 3)) * 0.1).astype(np.float32),
            rng.normal(size=(b, T, 17, 2)).astype(np.float32),
            np.tile(np.eye(3, dtype=np.float32), (b, 1, 1)))


_REFERENCE_GN = infer.reference_gn_relu_cconv
_REGRESSOR_ARGS = infer._regressor_args


def _gn_in_bf16(x, scale, bias, kernel, conv_bias, residual=None, dtype=None,
                **kw):
    """Control: GroupNorm statistics and output in the compute dtype (h36x
    takes them in float32 under bf16)."""
    if dtype is None or dtype.itemsize >= 4:
        return _REFERENCE_GN(x, scale, bias, kernel, conv_bias, residual=residual,
                             dtype=dtype, **kw)
    c = lambda t: t.to(dtype)  # noqa: E731
    return _REFERENCE_GN(c(x), c(scale), c(bias), c(kernel), c(conv_bias),
                         residual=None if residual is None else c(residual), **kw)


def _regressor_in_float32(phi2d, reg_params, dtype=None):
    """Control: the regressor in float32 (h36x's starts its iterate in phi's
    dtype and casts every Dense to bf16)."""
    return _REGRESSOR_ARGS(phi2d.float(), reg_params, None)


CONTROLS = {
    "float32 engine": (None, {}),
    "bf16 GroupNorm": (BF, {"reference_gn_relu_cconv": _gn_in_bf16}),
    "float32 regressor": (BF, {"_regressor_args": _regressor_in_float32}),
}


def _mean_gaps(params, feats, monkeypatch, dtype=BF, patches=None):
    """mean |port - h36x's bf16 model| per output, the port's outputs
    rounded to bf16 (h36x's are bf16), with `patches` (names of
    h36x_torch.infer) applied; and the port's output dtypes."""
    want = FlaxPHD(**SMALL, dtype=jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(feats), predict_future=True)
    model = _port(params, dtype=dtype)
    with monkeypatch.context() as m:
        for name, fn in (patches or {}).items():
            m.setattr(infer, name, fn)
        got = model(_t(feats), predict_future=True, use_kernels=False)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    gaps = {name: float((a.to(BF).float() - _t(b.astype(jnp.float32))).abs().mean())
            for name, a, b in zip(OUTPUTS, got, want)}
    return gaps, {a.dtype for a in got}


def test_bf16_forward_matches_flax(flax_params, rng, monkeypatch):
    """Every output of the eval forward, predict_future on, within MEAN_TOL
    of h36x's bf16 model; in bfloat16; the params stay float32."""
    feats = rng.normal(size=(GAP_BATCH, T, 32)).astype(np.float32)
    gaps, dtypes = _mean_gaps(flax_params, feats, monkeypatch)
    assert dtypes == {BF}
    assert all(gaps[k] <= MEAN_TOL[k] for k in OUTPUTS), gaps


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_bf16_forward_within_the_bounds_at_other_seeds(seed, monkeypatch):
    """The readings MEAN_TOL was set from: other params and features."""
    feats = np.random.default_rng(seed).normal(size=(GAP_BATCH, T, 32))
    gaps, dtypes = _mean_gaps(_seed_params(seed), feats.astype(np.float32),
                              monkeypatch)
    assert dtypes == {BF}
    assert all(gaps[k] <= MEAN_TOL[k] for k in OUTPUTS), gaps


@pytest.mark.parametrize("control", list(CONTROLS))
def test_bf16_bounds_refuse_other_semantics(control, monkeypatch):
    """A port that computes bf16 otherwise than h36x fails MEAN_TOL at
    every seed of the readings: a float32 engine with its outputs cast,
    GroupNorm statistics in bf16, or a float32 regressor."""
    dtype, patches = CONTROLS[control]
    for seed in range(5):
        feats = np.random.default_rng(seed).normal(size=(GAP_BATCH, T, 32))
        gaps, _ = _mean_gaps(_seed_params(seed), feats.astype(np.float32),
                             monkeypatch, dtype, patches)
        assert any(gaps[k] > MEAN_TOL[k] for k in OUTPUTS), (seed, gaps)


def test_float32_dtype_is_the_float32_engine_bit_for_bit(flax_params, rng):
    """dtype=torch.float32 casts nothing and forces no GroupNorm dtype: the
    same bits as dtype None (the engine as it was)."""
    tree = param_tree(_port(flax_params, dtype=None))
    x = _t(rng.normal(size=(2, T, 32)).astype(np.float32))
    with torch.inference_mode():
        a = phd_forward_fused(tree, x, True, groups=8, use_kernels=False, precise=True)
        b = phd_forward_fused(tree, x, True, groups=8, use_kernels=False, precise=True,
                              dtype=torch.float32)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_bf16_train_run_tracks_h36x(flax_params, rng):
    """20 plain AdamW steps on one batch, dropout 0, from h36x's init: the
    first loss (the loss at the init, as a step reports it) within rtol
    2e-2 of h36x's bf16 model's and of the port's f32 step's, the loss
    falling, every loss float32, the params float32 (h36x's
    TestMixedPrecision bounds; h36x's own 20-step run is its test's)."""
    batch = _batch(rng)
    pred = FlaxPHD(**SMALL, dropout=0.0, dtype=jnp.bfloat16).apply(
        {"params": flax_params}, jnp.asarray(batch[0]), train=True,
        rngs={"dropout": jax.random.key(1)})[2]
    want = float(jax_losses.mse3d(pred, jnp.asarray(batch[1])))

    model = _port(flax_params, dtype=None)
    f32 = make_train_step(model, make_optimizer(model, 1e-3)[0])(
        tuple(_t(a) for a in batch))["loss"].item()
    model = _port(flax_params)
    step = make_train_step(model, make_optimizer(model, 1e-3)[0])
    metrics = [step(tuple(_t(a) for a in batch)) for _ in range(20)]
    assert all(m["loss"].dtype == torch.float32 for m in metrics)
    got = [m["loss"].item() for m in metrics]
    assert np.isfinite(got).all() and got[-1] < got[0]
    np.testing.assert_allclose(got[0], want, rtol=2e-2)
    np.testing.assert_allclose(got[0], f32, rtol=2e-2)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_bf16_with_reprojection_loss(flax_params, rng):
    """lambda_2d > 0: bfloat16 joints projected through float32 K (promoted,
    as h36x's jnp.einsum does), a float32 loss."""
    model = _port(flax_params)
    batch = tuple(_t(a) for a in _batch(rng))
    m = grads_and_metrics(model, batch, lambda_2d=0.5)
    assert m["l2d"].dtype == torch.float32 and torch.isfinite(m["loss"])
    assert m["l2d"].item() > 0


def test_fused_step_under_bf16_is_the_float32_step(flax_params, rng):
    """--optim.fused true ignores the compute dtype, as h36x's fused step
    does: loss and every gradient equal the float32 model's bit for bit."""
    batch = tuple(_t(a) for a in _batch(rng))
    out = {}
    for dtype in (BF, None):
        model = _port(flax_params, dtype=dtype)
        make_optimizer(model, 1e-3)
        m = grads_and_metrics(model, batch, fused=True)
        out[dtype] = (m, {n: p.grad for n, p in model.named_parameters()
                          if p.grad is not None})
    (m_b, g_b), (m_f, g_f) = out[BF], out[None]
    assert m_b["loss"].dtype == torch.float32
    assert all(torch.equal(m_b[k], m_f[k]) for k in m_f)
    assert g_b.keys() == g_f.keys() and all(torch.equal(g_b[k], g_f[k]) for k in g_f)


def test_bf16_eval_step_matches_h36x(flax_params, rng):
    """The weighted eval step computes in the model's dtype, as h36x's
    model.apply does, even where the trainer would take the kernels."""
    feats, j3d, _, _ = _batch(rng)
    w = np.array([1, 1, 1, 0], np.float32)
    want = jax_make_weighted_eval_step(FlaxPHD(**SMALL, dtype=jnp.bfloat16))(
        jax.tree.map(jnp.asarray, flax_params),
        (jnp.asarray(feats), jnp.asarray(j3d), jnp.asarray(w)))
    got = make_weighted_eval_step(_port(flax_params), use_kernels=True)(
        (_t(feats), _t(j3d), _t(w)))
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=2e-2, err_msg=k)


def test_phase2_under_bf16_keeps_a_float32_loss(rng):
    """Phase 2 (f_AR's curriculum loss) under bf16: float32 loss and metrics,
    within rtol 2e-2 of h36x's bf16 step, gradients reaching f_AR."""
    t, input_len = 8, 3
    arch = dict(SMALL, ar_blocks=1)
    flax_model = FlaxPHD(**arch, dropout=0.0, dtype=jnp.bfloat16)
    params = jax.jit(flax_model.init)(jax.random.key(0), jnp.zeros((2, t, 32)))["params"]
    params = jax.tree.map(np.asarray, params)
    batch = (rng.normal(size=(4, t, 32)).astype(np.float32),
             (rng.normal(size=(4, t, 17, 3)) * 0.5).astype(np.float32))
    sgd = optax.sgd(1e-2)
    state = create_train_state(flax_model, sgd, jax.random.key(0), jnp.zeros((2, t, 32)))
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    _, want = jax_make_future_train_step(flax_model, sgd, input_len=input_len,
                                         donate=False)(
        state, tuple(jnp.asarray(a) for a in batch), jax.random.key(2), jnp.int32(3))
    model = PHDFor3DJoints(**arch, dropout=0.0, device="cpu", dtype=BF)
    model.load_state_dict(params_from_flax(params))
    before = model.f_AR.block0.conv1.kernel.detach().clone()
    step = make_future_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                                  input_len=input_len)
    got = step(tuple(_t(a) for a in batch), None, 3)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=2e-2, err_msg=k)
    assert not torch.equal(model.f_AR.block0.conv1.kernel, before)


@pytest.mark.parametrize("name, want", [("bfloat16", BF), ("bf16", BF),
                                        ("float32", None)])
def test_build_model_passes_the_dtype_flag(name, want):
    cfg = TrainConfig()
    cfg.model = dataclasses.replace(cfg.model, dtype=name, **dict(
        latent_dim=64, feature_dim=32, num_blocks=1, groups=8))
    check_supported(cfg)
    model = build_model(cfg, device="cpu")
    assert model.dtype == want
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_train_cli_bf16_one_epoch(tmp_path):
    """cli.train --model.dtype bfloat16 on the CPU: a finite epoch."""
    store = tmp_path / "store"
    store.mkdir()
    make_synthetic_store(store, n_shards=2, clips_per_shard=8, n_vars=2, seq_len=T,
                         feat_dim=32, subjects=(1, 5))
    train_main(["--train-root", str(store), "--train-subjects", "1",
                "--val-subjects", "5", "--outdir", str(tmp_path / "runs"),
                "--device", "cpu", "--model.dtype", "bfloat16",
                "--model.latent-dim", "64", "--model.feature-dim", "32",
                "--model.num-blocks", "1", "--model.groups", "8",
                "--data.seq-len", str(T), "--optim.batch-size", "4",
                "--optim.epochs", "1", "--optim.log-every", "0"])
    (row,) = [json.loads(line) for line in
              (tmp_path / "runs" / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(row[k]) for k in ("train_loss", "val_loss", "val_mpjpe"))
