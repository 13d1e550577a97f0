"""h36x_torch's phase 2 and grouped steps against h36x on the CPU: the
phase-2 training forward, the future train step at three horizons, the
curriculum, the weighted future eval step, phase-2 and grad-accum runs of
`cli.train.main` against h36x's `fit`, steps-per-dispatch against
ungrouped steps (bit for bit), the stacked feed and `--profile-dir`. Same
numpy-seeded inputs through both packages; small sizes (latent 64,
feature 32, G 8, T 8, one block each in f_movie and f_AR), dropout 0."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from h36x.config import TrainConfig as JaxTrainConfig
from h36x.data import features as jax_features
from h36x.data import sampler as jax_sampler
from h36x.models.phd import PHDFor3DJoints as FlaxPHD
from h36x.train.loop import fit as jax_fit
from h36x.train.state import create_train_state
from h36x.train.step import curriculum_horizon as jax_curriculum_horizon
from h36x.train.step import make_future_train_step as jax_make_future_train_step
from h36x.train.step import make_weighted_future_eval_step as jax_future_eval_step
from h36x_torch.cli.train import main as train_main
from h36x_torch.models.phd import PHDFor3DJoints, params_from_flax
from h36x_torch.train.loop import _batches
from h36x_torch.train.step import (
    curriculum_horizon,
    make_future_train_step,
    make_train_step,
    make_weighted_future_eval_step,
)
from tests.helpers import make_synthetic_store

T = 8
INPUT_LEN = 3
SMALL = dict(latent_dim=64, feature_dim=32, number_blocks=1, ar_blocks=1, groups=8)
ARCH_FLAGS = ["--data.seq-len", str(T), "--model.feature-dim", "32",
              "--model.latent-dim", "64", "--model.num-blocks", "1",
              "--model.ar-num-blocks", "1", "--model.groups", "8",
              "--model.dropout", "0"]
# phase 2: horizons 1, 3, 5 in epochs 0, 1, 2
PHASE2_FLAGS = ["--optim.phase", "2", "--optim.input-len", str(INPUT_LEN),
                "--optim.pred-len", "5", "--optim.curriculum-steps", "2"]
ROW_KEYS = ("lr", "train_loss", "train_mpjpe", "val_loss", "val_mpjpe", "val_bone")


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def flax_small():
    """A SMALL flax model at dropout 0 and its params (numpy), made once."""
    model = FlaxPHD(**SMALL, dropout=0.0)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((2, T, 32)))["params"]
    return model, jax.tree.map(np.asarray, params)


def _port(params):
    model = PHDFor3DJoints(**SMALL, dropout=0.0, device="cpu")
    model.load_state_dict(params_from_flax(params))
    return model


def _batch(rng, b=4):
    return (rng.normal(size=(b, T, 32)).astype(np.float32),
            (rng.normal(size=(b, T, 17, 3)) * 0.5).astype(np.float32))


# -- the phase-2 forward and step ---------------------------------------------------


def test_phase2_train_forward_matches_flax(flax_small, rng):
    flax_model, params = flax_small
    feats = rng.normal(size=(2, T, 32)).astype(np.float32)
    want = flax_model.apply({"params": params}, jnp.asarray(feats), predict_future=True,
                            train=True, rngs={"dropout": jax.random.key(0)})
    model = _port(params)
    phi, phi_hat, joints_hat = model(_t(feats), predict_future=True, train=True,
                                     use_kernels=False)
    assert joints_hat.requires_grad
    for got, w in ((phi, want[0]), (phi_hat, want[1]), (joints_hat, want[3])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)
    assert torch.all(phi_hat[:, 0] == 0)
    with pytest.raises(ValueError, match="use_kernels=False"):
        model(_t(feats), predict_future=True, train=True)


@pytest.mark.parametrize("horizon", [1, 3, T - INPUT_LEN])
def test_future_step_matches_h36x(flax_small, rng, horizon):
    """One future step through plain SGD over every module (as
    test_fused_train_step_matches_h36x: AdamW would amplify small grad
    differences): loss, l_ar, l3d, mpjpe at rtol 1e-5, params at rtol 1e-4."""
    flax_model, params = flax_small
    sgd = optax.sgd(1e-2)
    state = create_train_state(flax_model, sgd, jax.random.key(0), jnp.zeros((2, T, 32)))
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    batch = _batch(rng)
    jax_step = jax_make_future_train_step(flax_model, sgd, input_len=INPUT_LEN,
                                          donate=False)
    s_j, m_j = jax_step(state, tuple(jnp.asarray(a) for a in batch),
                        jax.random.key(2), jnp.int32(horizon))

    model = _port(params)
    step = make_future_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                                  input_len=INPUT_LEN)
    metrics = step(tuple(_t(a) for a in batch), None, horizon)
    assert set(metrics) == set(m_j)
    for key in m_j:
        np.testing.assert_allclose(metrics[key].item(), float(m_j[key]), rtol=1e-5,
                                   err_msg=key)
    want = params_from_flax(jax.tree.map(np.asarray, s_j.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_empty_ar_window_raises(flax_small, rng):
    model = _port(flax_small[1])
    step = make_future_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                                  input_len=T)
    feats, j3d = (_t(a) for a in _batch(rng))
    with pytest.raises(ValueError, match="AR window is empty"):
        step((feats, j3d), None, 1)
    with pytest.raises(ValueError, match="AR window is empty"):
        make_weighted_future_eval_step(model, input_len=T)((feats, j3d, torch.ones(4)))


@pytest.mark.parametrize("pred_len, steps", [(25, 25), (5, 2), (7, 0), (3, 10)])
def test_curriculum_horizon_matches_h36x(pred_len, steps):
    for epoch in range(40):
        assert (curriculum_horizon(epoch, pred_len, steps)
                == jax_curriculum_horizon(epoch, pred_len, steps))


def test_weighted_future_eval_matches_h36x(flax_small, rng):
    """Weighted sums with zero-weight rows, over the full window."""
    flax_model, params = flax_small
    feats, j3d = _batch(rng, b=5)
    w = np.array([1, 0, 1, 1, 0], np.float32)
    want = jax_future_eval_step(flax_model, input_len=INPUT_LEN, pred_len=4,
                                lambda_joints=0.7)(
        params, (jnp.asarray(feats), jnp.asarray(j3d), jnp.asarray(w)))
    got = make_weighted_future_eval_step(_port(params), input_len=INPUT_LEN, pred_len=4,
                                         lambda_joints=0.7)((_t(feats), _t(j3d), _t(w)))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-5,
                                   err_msg=key)
    assert got["n"].item() == 3.0


def test_grouped_modes_are_exclusive(flax_small):
    model = _port(flax_small[1])
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_train_step(model, opt, scan_steps=2, accum_steps=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_future_train_step(model, opt, scan_steps=2, accum_steps=2)


@pytest.mark.parametrize("mode", ["scan", "accum"])
def test_grouped_step_takes_a_stacked_group(flax_small, rng, mode):
    """A group of 3 stacked batches: scan makes 3 updates (as 3 ungrouped
    calls, bit for bit), accum 1 update from the mean gradient; metrics
    stacked (3,)."""
    params = flax_small[1]
    batches = [tuple(_t(a) for a in _batch(rng)) for _ in range(3)]
    group = tuple(torch.stack(xs) for xs in zip(*batches))
    grouped, single = _port(params), _port(params)
    kw = {"scan_steps": 3} if mode == "scan" else {"accum_steps": 3}
    step = make_future_train_step(grouped, torch.optim.SGD(grouped.parameters(), lr=0.1),
                                  input_len=INPUT_LEN, **kw)
    metrics = step(group, None, 4)
    assert all(v.shape == (3,) for v in metrics.values())
    assert step.eager_steps == (3 if mode == "scan" else 1) and step.graph_replays == 0
    opt = torch.optim.SGD(single.parameters(), lr=0.1)
    ref = make_future_train_step(single, opt, input_len=INPUT_LEN)
    if mode == "scan":
        for i, b in enumerate(batches):
            m = ref(b, None, 4)
            assert torch.equal(m["loss"], metrics["loss"][i])
        for (name, p), q in zip(grouped.named_parameters(), single.parameters()):
            assert torch.equal(p, q), name
    else:
        grads = []
        ref.horizon.fill_(4)
        for b in batches:
            ref.grads_fn(b, None)
            grads.append([p.grad.clone() for p in single.parameters()])
        for p, *gs in zip(single.parameters(), *grads):
            p.grad = (torch.zeros_like(p) + gs[0] + gs[1] + gs[2]) / 3
        opt.step()
        for (name, p), q in zip(grouped.named_parameters(), single.parameters()):
            torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7, msg=name)


# -- the stacked feed ---------------------------------------------------------------------


class _Rows:
    """A dataset whose batch rows are their indices."""

    def get_batch(self, idx):
        a = np.asarray(idx, np.float32)
        return (a[:, None], a, a, a, ["meta"] * len(idx))


def test_stacked_feed_flushes_on_a_ragged_tail():
    """stack=3 over batches of 4, 4, 4, 4, 2 rows: a full group, then the
    fourth batch alone (the next has another row count), then the tail."""
    sampler = [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11], [12, 13, 14, 15], [16, 17]]
    groups = list(_batches(_Rows(), sampler, torch.device("cpu"), None, stack=3))
    assert [tuple(g[0].shape) for g in groups] == [(3, 4, 1), (1, 4, 1), (1, 2, 1)]
    assert len(groups[0]) == 4  # meta dropped
    assert groups[1][1].tolist() == [[12, 13, 14, 15]]
    assert groups[2][1].tolist() == [[16, 17]]
    flat = list(_batches(_Rows(), sampler, torch.device("cpu"), None,
                         with_weights=True))
    assert len(flat) == 5 and flat[4][-1].tolist() == [1.0, 1.0]


# -- the trainer ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """16 train rows (subject 1, two variants) and 8 val clips (subject 5),
    T 8: 4 train batches of 4 a epoch."""
    root = tmp_path_factory.mktemp("store")
    make_synthetic_store(root, n_shards=2, clips_per_shard=8, n_vars=2, seq_len=T,
                         feat_dim=32, subjects=(1, 5))
    return root


@pytest.fixture(scope="module")
def init_params(tmp_path_factory):
    """h36x params (a bare flax blob) for --init-from, and the same tree."""
    model = FlaxPHD(**SMALL, dropout=0.0)
    params = jax.jit(model.init)(jax.random.key(5), jnp.zeros((2, T, 32)))["params"]
    path = tmp_path_factory.mktemp("init") / "init.msgpack"
    path.write_bytes(serialization.to_bytes(params))
    return path, jax.tree.map(np.asarray, params)


def rows(outdir) -> list:
    with open(outdir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def run_h36x(store, outdir, init, epochs, resume="", **optim):
    """h36x's fit on the store, from `init`, at the port tests' sizes."""
    cfg = JaxTrainConfig()
    cfg.train_root = cfg.val_root = str(store)
    cfg.train_subjects, cfg.val_subjects = [1], [5]
    cfg.data.seq_len = T
    cfg.model = dataclasses.replace(cfg.model, feature_dim=32, latent_dim=64,
                                    num_blocks=1, ar_num_blocks=1, groups=8,
                                    dropout=0.0)
    cfg.optim = dataclasses.replace(cfg.optim, epochs=epochs, batch_size=4, lr=1e-3,
                                    log_every=0, **optim)
    cfg.init_from = str(init)
    cfg.resume = str(resume)
    cfg.outdir = str(outdir)
    train_set = jax_features.FeatureClipDataset(store, subjects=[1], augment=True,
                                                shard_cache_size=64)
    val_set = jax_features.FeatureClipDataset(store, subjects=[5])
    return jax_fit(cfg, train_set, val_set,
                   jax_sampler.MixedShardBatchSampler(train_set, batch_size=4, seed=0),
                   jax_sampler.SequentialBatchSampler(val_set, batch_size=4))


def run_port(store, outdir, init, epochs, *flags):
    """The port's cli.train.main on the store, from `init`, on the CPU."""
    argv = ["--train-root", str(store), "--device", "cpu", "--train-subjects", "1",
            "--val-subjects", "5", *ARCH_FLAGS, "--optim.epochs", str(epochs),
            "--optim.batch-size", "4", "--optim.lr", "1e-3", "--optim.log-every", "0",
            "--outdir", str(outdir), *flags]
    if init:
        argv += ["--init-from", str(init)]
    return train_main(argv)


def assert_rows_close(got: list, want: list, rtol: float) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"]
        for key in ROW_KEYS:
            np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                       err_msg=f"epoch {w['epoch']} {key}")


def test_phase2_fit_matches_h36x(store, init_params, tmp_path, capsys):
    """Phase 2, 3 epochs (horizons 1, 3, 5), from the same params: every
    epoch's row within rtol 1e-4; input_proj, f_movie and f_3D bit for bit
    unchanged, f_AR moved."""
    init, params = init_params
    run_h36x(store, tmp_path / "jax", init, 3, phase=2, input_len=INPUT_LEN,
             pred_len=5, curriculum_steps=2)
    model, _ = run_port(store, tmp_path / "port", init, 3, *PHASE2_FLAGS)
    out = capsys.readouterr().out
    assert all(f"AR horizon {h}" in out for h in (1, 3, 5))
    assert_rows_close(rows(tmp_path / "port"), rows(tmp_path / "jax"), 1e-4)
    start = params_from_flax(params)
    for name, p in model.state_dict().items():
        if name.startswith("f_AR."):
            assert not torch.equal(p, start[name]), name
        else:
            assert torch.equal(p, start[name]), name


def test_phase2_refuses_fused(store, tmp_path):
    with pytest.raises(ValueError, match="--optim.fused only implements the phase-1 step"):
        run_port(store, tmp_path, "", 1, *PHASE2_FLAGS, "--optim.fused", "true")


def test_grad_accum_fit_matches_h36x(store, init_params, tmp_path):
    """--optim.grad-accum 2 (two updates an epoch from the mean gradient of
    two batches), 2 epochs: rows within rtol 1e-4; the manifest's step
    counts updates."""
    init, _ = init_params
    run_h36x(store, tmp_path / "jax", init, 2, grad_accum=2)
    run_port(store, tmp_path / "port", init, 2, "--optim.grad-accum", "2")
    got = rows(tmp_path / "port")
    assert_rows_close(got, rows(tmp_path / "jax"), 1e-4)
    assert [r["eager_steps"] for r in got] == [2, 2]
    assert json.loads((tmp_path / "port" / "last.json").read_text())["step"] == 4


@pytest.mark.parametrize("phase_flags", [[], PHASE2_FLAGS], ids=["phase1", "phase2"])
def test_steps_per_dispatch_equals_ungrouped(store, init_params, tmp_path, phase_flags):
    """--optim.steps-per-dispatch 3 over 4 batches an epoch (a group of 3,
    then a tail of 1) against ungrouped steps, 2 epochs: rows and final
    params bit for bit on the CPU."""
    init, _ = init_params
    grouped, _ = run_port(store, tmp_path / "k3", init, 2, *phase_flags,
                          "--optim.steps-per-dispatch", "3")
    single, _ = run_port(store, tmp_path / "k1", init, 2, *phase_flags)
    got, want = rows(tmp_path / "k3"), rows(tmp_path / "k1")
    for g, w in zip(got, want):
        assert {k: g[k] for k in ROW_KEYS} == {k: w[k] for k in ROW_KEYS}
        assert (g["graph_replays"], g["eager_steps"]) == (0, 4)
    for (name, p), q in zip(grouped.state_dict().items(), single.state_dict().values()):
        assert torch.equal(p, q), name
    steps = [json.loads((tmp_path / d / "last.json").read_text())["step"]
             for d in ("k3", "k1")]
    assert steps == [8, 8]


def test_profile_dir_writes_a_trace(store, tmp_path):
    run_port(store, tmp_path / "run", "", 1, "--profile-dir", str(tmp_path / "prof"))
    traces = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "train_step" for e in events)
