"""h36x_torch's training slice against h36x on the CPU: losses, AdamW and
the phase freeze, the fused train step, the sampler's batch order, the
shard store both ways, checkpoints, the trainer's refusals, and the slice
whole (the port's `cli.train.main` against h36x's `fit` on one store from
the same params). Same numpy-seeded inputs through both packages; small
sizes (latent 64, feature 32, G 8, T 6, one block)."""

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
from h36x.data import shards as jax_shards
from h36x.models.phd import PHDFor3DJoints as FlaxPHD
from h36x.train import checkpoint as jax_ckpt
from h36x.train import losses as jax_losses
from h36x.train.loop import fit as jax_fit
from h36x.train.state import create_train_state
from h36x.train.state import make_optimizer as jax_make_optimizer
from h36x.train.step import make_train_step as jax_make_train_step
from h36x_torch.cli.train import main as train_main
from h36x_torch.config import TrainConfig
from h36x_torch.data import features, sampler, shards
from h36x_torch.models.phd import PHDFor3DJoints, params_from_flax
from h36x_torch.parallel.feed import prefetch_to_device
from h36x_torch.train import checkpoint, losses
from h36x_torch.train.loop import check_supported
from h36x_torch.train.state import make_optimizer, set_learning_rate
from h36x_torch.train.step import (
    make_eval_step,
    make_train_step,
    make_weighted_eval_step,
)
from tests.helpers import make_synthetic_store

SMALL = dict(latent_dim=64, feature_dim=32, number_blocks=1, groups=8)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def flax_small():
    """A SMALL flax model at dropout 0 and its params (numpy), made once."""
    model = FlaxPHD(**SMALL, dropout=0.0)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((2, 6, 32)))["params"]
    return model, jax.tree.map(np.asarray, params)


def _port(params, **kw):
    model = PHDFor3DJoints(**SMALL, device="cpu", **kw)
    model.load_state_dict(params_from_flax(params))
    return model


def _batch(rng, b=4, t=6, f=32):
    return (rng.normal(size=(b, t, f)).astype(np.float32),
            (rng.normal(size=(b, t, 17, 3)) * 0.1).astype(np.float32),
            rng.normal(size=(b, t, 17, 2)).astype(np.float32),
            np.tile(np.eye(3, dtype=np.float32) * 500, (b, 1, 1))
            + np.array([[0, 0, 8], [0, 0, 8], [0, 0, 1]], np.float32))


# -- losses -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mse3d", "mpjpe", "bone_length_loss",
                                  "mse3d_per_row", "mpjpe_per_row",
                                  "bone_length_per_row", "bone_lengths"])
def test_losses_match_h36x(rng, name):
    pred = rng.normal(size=(3, 5, 17, 3)).astype(np.float32)
    gt = rng.normal(size=(3, 5, 17, 3)).astype(np.float32)
    args = (pred,) if name == "bone_lengths" else (pred, gt)
    got = getattr(losses, name)(*[_t(a) for a in args]).numpy()
    want = np.asarray(getattr(jax_losses, name)(*[jnp.asarray(a) for a in args]))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_mse2d_reproj_matches_h36x(rng):
    pred = rng.normal(size=(3, 5, 17, 3)).astype(np.float32)
    pred[..., 2] = np.abs(pred[..., 2]) + 2.0  # in front of the camera
    j2d = (rng.normal(size=(3, 5, 17, 2)) * 100).astype(np.float32)
    K = _batch(rng, b=3)[3]
    got = losses.mse2d_reproj(_t(pred), _t(j2d), _t(K)).item()
    want = float(jax_losses.mse2d_reproj(jnp.asarray(pred), jnp.asarray(j2d),
                                         jnp.asarray(K)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- AdamW and the freeze ---------------------------------------------------------


@pytest.mark.parametrize("phase", [None, 0, 2])
def test_adamw_and_freeze_match_optax(flax_small, rng, phase):
    """Five updates fed the SAME grads (a learning-rate change after the
    third): params at rtol 1e-6, f_AR untouched in phase 1, the other
    modules in phase 2."""
    _, params = flax_small
    tx, _ = jax_make_optimizer(1e-3, 1e-2, freeze_ar=True, phase=phase)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    model = _port(params)
    opt, frozen = make_optimizer(model, 1e-3, 1e-2, freeze_ar=True, phase=phase)
    assert frozen == {None: ("f_AR",), 0: (), 2: ("f_movie", "f_3D", "input_proj")}[phase]
    named = dict(model.named_parameters())
    for step in range(5):
        if step == 3:
            from h36x.train.state import set_learning_rate as jax_set_lr

            jax_set_lr(opt_state, 3e-4)
            set_learning_rate(opt, 3e-4)
        grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                             params)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
        flat = params_from_flax(grads)
        for name, p in named.items():
            p.grad = flat[name] if p.requires_grad else None
        opt.step()
    want = params_from_flax(jax.tree.map(np.asarray, jparams))
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    if phase is None:
        assert torch.equal(named["f_AR.block0.conv1.kernel"],
                           params_from_flax(params)["f_AR.block0.conv1.kernel"])
    if phase == 2:
        for name in ("f_movie.block0.conv1.kernel", "f_3D.fc1.kernel",
                     "input_proj.kernel"):
            assert torch.equal(named[name], params_from_flax(params)[name])
    assert int(opt.count) == 5


def test_unknown_frozen_module_raises(flax_small, monkeypatch):
    from h36x_torch.train import state

    monkeypatch.setitem(state.PHASE_FROZEN, 0, ("f_typo",))
    with pytest.raises(ValueError, match="f_typo"):
        make_optimizer(_port(flax_small[1]), 1e-3, phase=0)


# -- train step -------------------------------------------------------------------


def test_fused_train_step_matches_h36x(flax_small, rng):
    """One make_train_step(fused=True) step through plain SGD (as
    tests/test_train_step.py::TestFusedTrainStep: AdamW would amplify small
    grad differences), dropout 0: loss rtol 1e-5, params rtol 1e-4."""
    flax_model, params = flax_small
    sgd = optax.sgd(1e-2)
    state = create_train_state(flax_model, sgd, jax.random.key(0),
                               jnp.zeros((2, 6, 32)))
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    batch = _batch(rng)
    jax_step = jax_make_train_step(flax_model, sgd, donate=False, fused=True,
                                   interpret=True)
    s_j, m_j = jax_step(state, tuple(jnp.asarray(a) for a in batch),
                        jax.random.key(2))

    model = _port(params, dropout=0.0)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                           fused=True)
    metrics = step(tuple(_t(a) for a in batch))
    np.testing.assert_allclose(metrics["loss"].item(), float(m_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["mpjpe"].item(), float(m_j["mpjpe"]), rtol=1e-5)
    want = params_from_flax(jax.tree.map(np.asarray, s_j.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_train_forward_matches_flax_apply_train(flax_small, rng):
    flax_model, params = flax_small
    feats = rng.normal(size=(2, 6, 32)).astype(np.float32)
    want = flax_model.apply({"params": params}, jnp.asarray(feats), train=True,
                            rngs={"dropout": jax.random.key(0)})
    model = _port(params, dropout=0.0)
    for use_kernels in (True, False):
        phi, joints = model(_t(feats), train=True, use_kernels=use_kernels)
        assert joints.requires_grad
        np.testing.assert_allclose(phi.detach().numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(joints.detach().numpy(), np.asarray(want[2]),
                                   rtol=1e-4, atol=1e-5)


def test_dropout_masks_follow_the_generator(flax_small, rng):
    """Same generator seed, same masks: the fused and plain train forwards
    agree at dropout 0.5; another seed gives other joints."""
    model = _port(flax_small[1], dropout=0.5)
    feats = _t(rng.normal(size=(2, 6, 32)).astype(np.float32))
    outs = [model(feats, train=True, use_kernels=k,
                  dropout_generator=torch.Generator().manual_seed(s))[1]
            for k, s in ((True, 3), (False, 3), (True, 4))]
    torch.testing.assert_close(outs[0], outs[1])
    assert not torch.allclose(outs[0], outs[2])
    with pytest.raises(ValueError, match="Generator"):
        model(feats, train=True)


def test_weighted_eval_step_sums(flax_small, rng):
    model = _port(flax_small[1])
    feats, j3d = (_t(a) for a in _batch(rng)[:2])
    w = torch.tensor([1.0, 1.0, 0.0, 0.0])
    m = make_weighted_eval_step(model)((feats, j3d, w))
    pred = model(feats)[2]
    assert m["n"].item() == 2.0
    means = make_eval_step(model)((feats, j3d))
    np.testing.assert_allclose(means["mpjpe"].item(),
                               losses.mpjpe(pred, j3d).item(), rtol=1e-6)
    np.testing.assert_allclose(m["mpjpe"].item(),
                               losses.mpjpe_per_row(pred, j3d)[:2].sum().item(),
                               rtol=1e-6)


# -- sampler, store, feed, checkpoints --------------------------------------------


class _FakeDataset:
    def __init__(self, shard_ids):
        self.ids = shard_ids

    def __len__(self):
        return len(self.ids)

    def shard_id_of(self, i):
        return self.ids[i]


@pytest.mark.parametrize("kw", [dict(batch_size=8), dict(batch_size=8, drop_last=False),
                                dict(batch_size=4, shuffle=False),
                                dict(batch_size=8, shards_per_batch=8)])
def test_sampler_batch_order_matches_h36x(kw):
    ds = _FakeDataset([i % 5 for i in range(37)] + [7] * 11)
    for seed in (0, 3):
        a = sampler.MixedShardBatchSampler(ds, seed=seed, **kw)
        b = jax_sampler.MixedShardBatchSampler(ds, seed=seed, **kw)
        assert len(a) == len(b)
        for epoch in (0, 1, 4):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(a) == list(b)
    seq = sampler.SequentialBatchSampler(ds, batch_size=7)
    assert list(seq) == list(jax_sampler.SequentialBatchSampler(ds, batch_size=7))


def _store_arrays(rng, rows, t=6, f=32, feat_dtype="float32"):
    return {"feats": rng.normal(size=(rows, t, f)).astype(feat_dtype),
            "joints3d": (rng.normal(size=(rows, t, 17, 3)) * 1000).astype(np.float32),
            "joints2d": (rng.normal(size=(rows, t, 17, 2)) * 100).astype(np.float32),
            "K": np.tile(np.eye(3, dtype=np.float32), (rows, 1, 1))}


@pytest.mark.parametrize("writer", ["port", "h36x"])
@pytest.mark.parametrize("feat_dtype", ["float32", "float16"])
def test_store_reads_the_same_in_both_packages(tmp_path, rng, writer, feat_dtype):
    """A store written by either package reads byte for byte in the other:
    shard arrays, meta, index, and the datasets' batches."""
    mod = shards if writer == "port" else jax_shards
    w = mod.ShardWriter(tmp_path, n_vars=2)
    clips = []
    for sid in range(2):
        arrays = _store_arrays(rng, 6, feat_dtype=feat_dtype)
        meta = [{"subject": 1 + sid, "row": r} for r in range(6)]
        w.write(arrays, meta)
        clips += [{"shard_id": sid, "row": 2 * c, "subject": 1 + sid} for c in range(3)]
    mod.write_index(tmp_path, clips, n_shards=2, n_clips=6, n_variants=2,
                    aug_names=["orig", "hflip"], seq_len=6, frame_skip=2,
                    feat_dtype=feat_dtype)
    assert shards.load_index(tmp_path) == jax_shards.load_index(tmp_path)
    for sid in range(2):
        a = shards.read_shard(shards.shard_path(tmp_path, sid))
        b = jax_shards.read_shard(jax_shards.shard_path(tmp_path, sid))
        assert a["meta"] == b["meta"] and a["n_vars"] == b["n_vars"]
        for key in shards.ARRAY_KEYS:
            assert a[key].dtype == b[key].dtype
            assert np.asarray(a[key]).tobytes() == np.asarray(b[key]).tobytes()
    assert jax_shards.verify_store(tmp_path)["errors"] == []
    got = features.FeatureClipDataset(tmp_path, subjects=[1, 2], augment=True)
    want = jax_features.FeatureClipDataset(tmp_path, subjects=[1, 2], augment=True)
    idx = [5, 0, 11, 3]
    for a, b in zip(got.get_batch(idx), want.get_batch(idx)):
        np.testing.assert_array_equal(np.asarray(a, dtype=np.float32), b)


def test_feed_casts_features_and_raises_producer_errors(rng):
    batches = [_batch(rng) for _ in range(3)]
    out = list(prefetch_to_device(iter(batches), torch.device("cpu"),
                                  feats_dtype=torch.bfloat16))
    assert len(out) == 3 and out[0][0].dtype == torch.bfloat16
    assert out[0][1].dtype == torch.float32
    torch.testing.assert_close(out[2][1], _t(batches[2][1]))

    def broken():
        yield batches[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(prefetch_to_device(broken(), torch.device("cpu")))


def test_checkpoint_params_read_by_h36x(flax_small, tmp_path):
    """A full checkpoint of the port: params read by h36x bit for bit, and
    the optimizer state in optax's layout, which h36x's load_checkpoint
    restores into its own TrainState with equal values."""
    model = _port(flax_small[1], dropout=0.0)
    opt, _ = make_optimizer(model, 1e-3)
    model(torch.zeros(2, 6, 32), train=True)[1].sum().backward()
    opt.step()
    path = checkpoint.save_checkpoint(tmp_path, "best", model, opt, epoch=3,
                                      best_val=0.5, step=7, config={"a": 1},
                                      extra={"no_improve": 0})
    manifest = json.loads((tmp_path / "best.json").read_text())
    assert {k: manifest[k] for k in ("epoch", "best_val", "step", "config",
                                     "no_improve")} == {
        "epoch": 3, "best_val": 0.5, "step": 7, "config": {"a": 1}, "no_improve": 0}
    assert manifest["nbytes"] == path.stat().st_size
    raw = jax_ckpt.load_params_raw(path)
    for name, value in params_from_flax(raw).items():
        assert torch.equal(value, model.state_dict()[name]), name
    restored = jax_ckpt.load_params_only(path, flax_small[1])
    assert jax.tree.structure(restored) == jax.tree.structure(flax_small[1])
    blob = serialization.msgpack_restore(path.read_bytes())
    assert set(blob) == {"params", "opt_state", "step"}
    assert blob["opt_state"]["inner_states"]["frozen"] == {"inner_state": {}}
    inner = blob["opt_state"]["inner_states"]["trainable"]["inner_state"]
    adam = inner["inner_state"]["0"]
    assert int(inner["count"]) == int(adam["count"]) == 1
    assert adam["mu"]["f_AR"]["block0"]["conv1"]["kernel"] == {}  # frozen: MaskedNode

    tx, _ = jax_make_optimizer(1e-3)
    template = create_train_state(flax_small[0], tx, jax.random.key(1),
                                  jnp.zeros((2, 6, 32)))
    state, jmanifest = jax_ckpt.load_checkpoint(tmp_path, "best", template)
    assert int(state.step) == 7 and jmanifest["epoch"] == 3
    jinner = state.opt_state.inner_states["trainable"].inner_state
    assert int(jinner.count) == 1
    np.testing.assert_array_equal(jinner.hyperparams["learning_rate"], np.float32(1e-3))
    jmu = params_from_flax(jax.tree.map(np.asarray, jinner.inner_state[0].mu))
    for name, p in model.named_parameters():
        if p.requires_grad:
            assert torch.equal(jmu[name], opt.state[p]["mu"]), name


# -- the trainer --------------------------------------------------------------------


@pytest.mark.parametrize("field, value", [
    ("ckpt_backend", "orbax"), ("mesh.data", 2),
    ("mesh.model", 2), ("dist.local_devices", 2),
])
def test_trainer_refuses_what_this_slice_does_not_run(field, value):
    """More devices than processes (mesh.data 2 on one process; two local
    devices) raise. Orbax checkpoints and tensor parallelism, refused until
    they were ported, now pass the check (a model axis of 2 on 2 processes,
    orbax: tests/test_torch_tp.py runs it)."""
    cfg = TrainConfig()
    head, _, leaf = field.rpartition(".")
    setattr(getattr(cfg, head) if head else cfg, leaf, value)
    if field in ("ckpt_backend", "mesh.model"):
        cfg.ckpt_backend = "orbax"
        cfg.dist.num_processes = value if field == "mesh.model" else 1
        mesh = check_supported(cfg)
        assert mesh.model == (value if field == "mesh.model" else 1)
        return
    with pytest.raises(NotImplementedError, match="later slice"):
        check_supported(cfg)


@pytest.mark.parametrize("value", ["float32", "bfloat16", "bf16", "float16"])
def test_trainer_accepts_bfloat16_and_refuses_an_unknown_dtype(value):
    """h36x's --model.dtype names run (tests/test_torch_bf16.py holds the bf16
    model to h36x's); another name raises ValueError."""
    cfg = TrainConfig()
    cfg.model.dtype = value
    if value == "float16":
        with pytest.raises(ValueError, match="unknown --model.dtype"):
            check_supported(cfg)
    else:
        check_supported(cfg)


def test_train_cli_without_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--train-root", str(tmp_path)])


def test_slice_whole_matches_h36x_fit(tmp_path, capsys):
    """The port's cli.train.main and h36x's fit on one store, from the same
    h36x params (--init-from), dropout 0, 2 epochs: train loss and val MPJPE
    of every epoch within rtol 1e-4."""
    store = tmp_path / "store"
    store.mkdir()
    make_synthetic_store(store, n_shards=2, clips_per_shard=8, n_vars=2, seq_len=6,
                         feat_dim=32, subjects=(1, 5))
    cfg = JaxTrainConfig()
    cfg.train_root = cfg.val_root = str(store)
    cfg.train_subjects, cfg.val_subjects = [1], [5]
    cfg.data.seq_len = 6
    cfg.model = dataclasses.replace(cfg.model, feature_dim=32, latent_dim=64,
                                    num_blocks=1, groups=8, dropout=0.0)
    cfg.optim = dataclasses.replace(cfg.optim, epochs=2, batch_size=8, lr=1e-3,
                                    log_every=0)
    model = FlaxPHD(**SMALL, dropout=0.0)
    params = jax.jit(model.init)(jax.random.key(5), jnp.zeros((2, 6, 32)))["params"]
    init = tmp_path / "init.msgpack"
    init.write_bytes(serialization.to_bytes(params))
    cfg.init_from = str(init)
    cfg.outdir = str(tmp_path / "jax")
    train_set = jax_features.FeatureClipDataset(store, subjects=[1], augment=True,
                                                shard_cache_size=64)
    val_set = jax_features.FeatureClipDataset(store, subjects=[5])
    jax_fit(cfg, train_set, val_set,
            jax_sampler.MixedShardBatchSampler(train_set, batch_size=8, seed=0),
            jax_sampler.SequentialBatchSampler(val_set, batch_size=8))

    _, best = train_main([
        "--train-root", str(store), "--device", "cpu", "--init-from", str(init),
        "--train-subjects", "1", "--val-subjects", "5", "--data.seq-len", "6",
        "--model.feature-dim", "32", "--model.latent-dim", "64",
        "--model.num-blocks", "1", "--model.groups", "8", "--model.dropout", "0",
        "--optim.epochs", "2", "--optim.batch-size", "8", "--optim.lr", "1e-3",
        "--optim.log-every", "0", "--optim.fused", "true",
        "--outdir", str(tmp_path / "port")])
    assert "Initialized model weights from" in capsys.readouterr().out
    rows = {name: [json.loads(line) for line in
                   (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
            for name in ("jax", "port")}
    assert len(rows["port"]) == len(rows["jax"]) == 2
    for want, got in zip(rows["jax"], rows["port"]):
        for key in ("lr", "train_loss", "train_mpjpe", "val_loss", "val_mpjpe"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    for name in ("best.msgpack", "best.json", "last.msgpack", "last.json"):
        assert (tmp_path / "port" / name).exists()
    np.testing.assert_allclose(best, min(r["val_mpjpe"] for r in rows["jax"]),
                               rtol=1e-4)


def _same_keys(want: dict, got: dict) -> dict:
    """`want` cut down to the (nested) keys of `got`."""
    return {k: _same_keys(want[k], v) if isinstance(v, dict) else want[k]
            for k, v in got.items()}


def test_train_config_has_h36x_fields_and_defaults():
    """Every field of the port's config is h36x's, with its name and default,
    so the same flags parse to the same values."""
    from h36x.config import parse_into as jax_parse
    from h36x_torch.config import parse_into

    port, jax_cfg = dataclasses.asdict(TrainConfig()), dataclasses.asdict(JaxTrainConfig())
    assert port == _same_keys(jax_cfg, port)
    argv = ["--optim.batch-size", "8", "--optim.fused", "true", "--train-subjects",
            "1", "9", "--data.max-clips", "3", "--model.dropout", "0"]
    port = dataclasses.asdict(parse_into(TrainConfig(), argv))
    assert port == _same_keys(dataclasses.asdict(jax_parse(JaxTrainConfig(), argv)), port)


@pytest.mark.parametrize("flag, value", [
    ("--dist.platform", "cpu"), ("--dist.local-devices", "2"),
    ("--dist.coordinator", "localhost:1234"), ("--dist.process-id", "0"),
])
def test_train_cli_has_no_flag_it_does_not_read(flag, value):
    """The multi-process fields came with the slice that reads them
    (h36x_torch.parallel.distributed.setup_from_config): each flag parses to
    h36x's value, and the port's config has no field h36x's lacks."""
    from h36x.config import parse_into as jax_parse
    from h36x_torch.config import parse_into

    port = dataclasses.asdict(parse_into(TrainConfig(), [flag, value]))
    assert port == dataclasses.asdict(jax_parse(JaxTrainConfig(), [flag, value]))
