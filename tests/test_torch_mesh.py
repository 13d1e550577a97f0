"""h36x_torch's single-process device mesh against h36x's on the CPU: h36x
runs on the 8 virtual host devices tests/conftest.py forces, the port on
virtual CPU devices (a device list naming `cpu` several times).

- `make_mesh` shapes, device order and errors as h36x's `make_mesh` and
  `make_multislice_mesh`;
- `fit(mesh=data 4)` against h36x's `fit` over a 4-device mesh, and data 2
  x model 2 in one process (the plain step) against h36x's same mesh, at
  the rtol of tests/test_torch_dist.py (1e-5); dropout and grad-accum over
  2 replicas against the port's one device;
- `evaluate` over data 4 with a padded tail (tests/test_loop_e2e.py's
  case) against the exact dataset means of h36x's forward;
- `evaluate_test(mesh=)` against h36x's over 8 devices;
- `make_feature_fn(mesh=)` at n = 8 and 5 frames (tests/test_extract.py's
  cases), both engines, against h36x's data-parallel function and the
  port's single device.

Small sizes as tests/test_torch_phase2.py (latent 64, feature 32, G 8,
T 8, one block each), its store and init."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h36x.config import TrainConfig as JaxTrainConfig
from h36x.data import features as jax_features
from h36x.data import sampler as jax_sampler
from h36x.parallel import distributed as jax_dist
from h36x.parallel import mesh as jax_mesh
from h36x.train.loop import fit as jax_fit
from h36x_torch.config import TrainConfig, parse_into
from h36x_torch.data.features import FeatureClipDataset
from h36x_torch.data.sampler import MixedShardBatchSampler, SequentialBatchSampler
from h36x_torch.models.phd import PHDFor3DJoints, params_from_flax
from h36x_torch.parallel import distributed
from h36x_torch.parallel.local import Replicas, merge_rows, pad_rows, split_rows
from h36x_torch.parallel.mesh import MeshDevice, data_axis_size, make_mesh
from h36x_torch.train import results
from h36x_torch.train.loop import evaluate, fit
from h36x_torch.train.step import make_weighted_eval_step
from tests.helpers import make_synthetic_store
from tests.test_torch_phase2 import (  # noqa: F401 (fixtures)
    ARCH_FLAGS,
    PHASE2_FLAGS,
    ROW_KEYS,
    T,
    assert_rows_close,
    init_params,
    rows,
    store,
)

CPU = torch.device("cpu")
ROW_RTOL = 1e-5  # tests/test_torch_dist.py's 2 processes against h36x's fit


def cpus(n):
    return [CPU] * n


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops on one intra-op thread: the test workers share the cores,
    and several threads each only contend (the file's time drops from
    about 65 s to 53 s alone)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- make_mesh ---------------------------------------------------------------------


@pytest.mark.parametrize("data, model", [(-1, 1), (8, 1), (4, 2), (-1, 2), (2, 4)])
def test_make_mesh_shapes_match_h36x(data, model):
    """The same axis sizes over 8 devices, and device k of the list at the
    coordinates h36x puts jax.devices()[k]."""
    want = jax_mesh.make_mesh(data, model, devices=jax.devices()[:8])
    got = make_mesh(data, model, devices=cpus(8))
    assert got.shape == {"slice": 1, **dict(want.shape)}
    ids = np.vectorize(lambda d: d.id)(want.devices)
    order = np.vectorize(lambda d: d.index)(got.devices)[0]
    np.testing.assert_array_equal(order, ids - ids.min())
    assert len(got.local_groups()) == got.data and {len(g) for g in got.local_groups()} == {
        got.model}


@pytest.mark.parametrize("data, model, slices", [(3, 2, 1), (-1, 3, 1), (-1, 3, 2), (3, 1, 2)])
def test_make_mesh_errors_match_h36x(data, model, slices):
    def jax_call():
        if slices == 1:
            return jax_mesh.make_mesh(data, model, devices=jax.devices()[:8])
        return jax_dist.make_multislice_mesh(slices, data, model, devices=jax.devices()[:8])

    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        if slices == 1:
            make_mesh(data, model, devices=cpus(8))
        else:
            distributed.make_multislice_mesh(slices, data, model, devices=cpus(8))
    assert str(got.value) == str(want.value)


def test_multislice_mesh_matches_h36x():
    want = jax_dist.make_multislice_mesh(2, -1, 2, devices=jax.devices()[:8])
    got = distributed.make_multislice_mesh(2, -1, 2, devices=cpus(8))
    assert got.shape == dict(want.shape)
    assert data_axis_size(got) == jax_mesh.data_axis_size(want) == 4
    # over 2 processes of 4 devices: this process (0) holds slice 0, two
    # data replicas of a model axis of 2; process 1's devices it cannot name
    two = make_mesh(2, 2, cpus(4), slices=2, n_processes=2)
    assert [d.process for d in two.devices[1].reshape(-1)] == [1] * 4
    assert two.local_groups() == [cpus(2), cpus(2)]
    assert two.devices[1, 0, 0] == MeshDevice(1, 0, None)


def test_a_model_axis_over_processes_of_several_devices_raises():
    """The one layout the port does not run: a model group spanning
    processes that hold several devices each (2 processes x 2 devices,
    model 4); model 2 there lies inside each process."""
    with pytest.raises(NotImplementedError, match="model axis must lie inside"):
        make_mesh(1, 4, cpus(2), n_processes=2).local_groups()
    assert make_mesh(2, 2, cpus(2), n_processes=2).local_groups() == [cpus(2)]


def test_rows_split_and_merge_in_order():
    x = torch.arange(5 * 3, dtype=torch.float32).reshape(5, 3)
    blocks = split_rows(pad_rows(x, 4), cpus(4))
    assert [b.shape[0] for b in blocks] == [2, 2, 2, 2]
    assert torch.equal(blocks[2][1], torch.zeros(3))
    assert torch.equal(merge_rows(blocks, 5), x)
    frames = np.ones((5, 2, 2, 3), np.uint8)
    assert pad_rows(frames, 4).shape == (8, 2, 2, 3) and pad_rows(frames, 5) is frames
    with pytest.raises(ValueError, match="pad_rows first"):
        split_rows(x, cpus(2))


# -- fit over a mesh -----------------------------------------------------------------


def run_h36x(store, outdir, init, epochs, mesh, **optim):
    """h36x's fit over `mesh` (the port tests' sizes, dropout 0)."""
    cfg = JaxTrainConfig()
    cfg.train_root = cfg.val_root = str(store)
    cfg.train_subjects, cfg.val_subjects = [1], [5]
    cfg.data.seq_len = T
    cfg.model = dataclasses.replace(cfg.model, feature_dim=32, latent_dim=64,
                                    num_blocks=1, ar_num_blocks=1, groups=8, dropout=0.0)
    cfg.optim = dataclasses.replace(cfg.optim, epochs=epochs, batch_size=4, lr=1e-3,
                                    log_every=0, **optim)
    cfg.init_from, cfg.outdir = str(init), str(outdir)
    train_set = jax_features.FeatureClipDataset(store, subjects=[1], augment=True,
                                                shard_cache_size=64)
    val_set = jax_features.FeatureClipDataset(store, subjects=[5])
    return jax_fit(cfg, train_set, val_set,
                   jax_sampler.MixedShardBatchSampler(train_set, batch_size=4, seed=0),
                   jax_sampler.SequentialBatchSampler(val_set, batch_size=4), mesh=mesh)


def run_port(store, outdir, init, epochs, mesh, *flags):
    """The port's fit over `mesh` (None: one CPU device), from `init`."""
    argv = ["--train-root", str(store), "--train-subjects", "1", "--val-subjects", "5",
            *ARCH_FLAGS, "--optim.epochs", str(epochs), "--optim.batch-size", "4",
            "--optim.lr", "1e-3", "--optim.log-every", "0", "--outdir", str(outdir),
            "--init-from", str(init), *flags]
    cfg = parse_into(TrainConfig(), argv)
    train_set = FeatureClipDataset(store, subjects=[1], augment=True, shard_cache_size=64)
    val_set = FeatureClipDataset(store, subjects=[5])
    return fit(cfg, train_set, val_set,
               MixedShardBatchSampler(train_set, batch_size=4, shuffle=True,
                                      drop_last=True, seed=0),
               SequentialBatchSampler(val_set, batch_size=4), mesh=mesh, device="cpu")


@pytest.mark.parametrize("data, model", [(4, 1), (2, 2)])
def test_fit_over_a_mesh_matches_h36x(store, init_params, tmp_path, data, model):
    """2 epochs over a data x model mesh of 4 devices in one process (the
    plain step; model 2 splits the wide layers over 2 devices) against
    h36x's fit over the same mesh: every row within ROW_RTOL. The port's
    msgpack `last` holds the model's full params, bit for bit."""
    init, _ = init_params
    run_h36x(store, tmp_path / "jax", init, 2,
             jax_mesh.make_mesh(data, model, devices=jax.devices()[:4]))
    port, _ = run_port(store, tmp_path / "port", init, 2,
                       make_mesh(data, model, devices=cpus(4)))
    assert_rows_close(rows(tmp_path / "port"), rows(tmp_path / "jax"), ROW_RTOL)
    assert (port.tp is not None) == (model > 1)
    from h36x_torch.train.checkpoint import load_params_only

    saved = {k: v.clone() for k, v in port.state_dict().items()}
    last = load_params_only(tmp_path / "port" / "last.msgpack", saved)
    assert all(torch.equal(last[k], saved[k]) for k in saved)


@pytest.mark.parametrize("flags", [
    ("--model.dropout", "0.5"), ("--optim.grad-accum", "2"),
    ("--optim.steps-per-dispatch", "3"),
    ("--model.dropout", "0.5", "--optim.grad-accum", "2", *PHASE2_FLAGS),
])
def test_two_replicas_match_one_device(store, init_params, tmp_path, flags):
    """Over a data axis of 2 devices: dropout 0.5 (each replica keeps its
    rows of the global batch's masks), gradient accumulation, grouped steps
    (run eagerly over replicas) and phase 2 with both: every row within
    ROW_RTOL of the port's one-device run."""
    init, _ = init_params
    run_port(store, tmp_path / "one", init, 2, None, *flags)
    run_port(store, tmp_path / "two", init, 2, make_mesh(2, devices=cpus(2)), *flags)
    got, want = rows(tmp_path / "two"), rows(tmp_path / "one")
    assert_rows_close(got, want, ROW_RTOL)
    if "--optim.steps-per-dispatch" in flags:
        assert [(r["graph_replays"], r["eager_steps"]) for r in got] == [(0, 4), (0, 4)]


def test_fit_chooses_h36x_mesh_over_local_devices(store, init_params, tmp_path, capsys):
    """mesh=None over --dist.local-devices 8 at batch 4: h36x's automatic
    data axis shrinks to 4 and says so; --mesh.data 3 raises h36x's error."""
    init, _ = init_params
    run_port(store, tmp_path / "auto", init, 1, None, "--dist.local-devices", "8")
    assert "mesh: using 4/8 devices (data=4, model=1" in capsys.readouterr().out
    with pytest.raises(ValueError, match="--mesh.data 3 does not divide the batch size"):
        run_port(store, tmp_path / "three", init, 1, None, "--dist.local-devices", "8",
                 "--mesh.data", "3")


# -- evaluation ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def ten_rows(tmp_path_factory):
    """1 shard x 5 clips x 2 variants = 10 rows; batch 4 leaves a tail of 2."""
    root = tmp_path_factory.mktemp("ten")
    make_synthetic_store(root, n_shards=1, clips_per_shard=5, n_vars=2, seq_len=T,
                         feat_dim=32, subjects=(1,))
    return root


@pytest.fixture(scope="module")
def flax_and_port():
    from h36x.models.phd import PHDFor3DJoints as FlaxPHD

    model = FlaxPHD(latent_dim=64, feature_dim=32, joints_num=17, number_blocks=1)
    params = model.init(jax.random.key(0), jnp.zeros((2, T, 32)))["params"]
    port = PHDFor3DJoints(latent_dim=64, feature_dim=32, number_blocks=1, device="cpu")
    port.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return model, params, port


def test_evaluate_masks_padded_tail_rows(ten_rows, flax_and_port):
    """evaluate over data 4 (the tail of 2 rows padded to 4, weight 0)
    equals the exact dataset means of h36x's forward over all 10 rows."""
    from h36x.train.losses import mpjpe, mse3d

    flax_model, params, port = flax_and_port
    ds = FeatureClipDataset(str(ten_rows), subjects=[1], augment=True)
    assert len(ds) == 10
    mesh = make_mesh(4, devices=cpus(4))
    step = make_weighted_eval_step(port, replicas=Replicas(port, mesh.local_groups(),
                                                           grads=False))
    got = evaluate(step, ds, SequentialBatchSampler(ds, batch_size=4), CPU,
                   torch.float32, pad_to=data_axis_size(mesh))
    feats, j3d = ds.get_batch(list(range(10)))[:2]
    pred = flax_model.apply({"params": params}, jnp.asarray(feats))[2]
    np.testing.assert_allclose(got["loss"], float(mse3d(pred, jnp.asarray(j3d))), rtol=1e-5)
    np.testing.assert_allclose(got["mpjpe"], float(mpjpe(pred, jnp.asarray(j3d))), rtol=1e-5)


@pytest.mark.parametrize("data, model", [(8, 1), (2, 2)])
def test_evaluate_test_mesh_matches_h36x(tmp_path, flax_and_port, data, model):
    """evaluate_test over h36x's mesh of the same shape (14 rows at batch 4:
    a ragged tail), against h36x's at rtol 1e-5 and the port's one device
    at 1e-6; the caller's model keeps its own forward."""
    from h36x.data.features import FeatureClipDataset as JaxDataset
    from h36x.train import results as jax_results

    make_synthetic_store(tmp_path, n_shards=2, clips_per_shard=7, n_vars=1, seq_len=T,
                         feat_dim=32, subjects=(9,))
    flax_model, params, port = flax_and_port
    want = jax_results.evaluate_test(
        flax_model, params, JaxDataset(str(tmp_path), subjects=[9], test_set=True), 4,
        mesh=jax_mesh.make_mesh(data, model, devices=jax.devices()[:data * model]))
    ds = FeatureClipDataset(tmp_path, subjects=[9], test_set=True)
    got = results.evaluate_test(port, ds, 4,
                                mesh=make_mesh(data, model, devices=cpus(data * model)))
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5)
    np.testing.assert_allclose(got, results.evaluate_test(port, ds, 4), rtol=1e-6)
    assert port.tp is None


# -- extraction ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def backbones():
    from h36x.models.resnet import ResNet50 as FlaxResNet50
    from h36x.models.resnet import init_resnet_params
    from h36x_torch.models.resnet import ResNet50
    from h36x_torch.models.resnet import params_from_flax as resnet_from_flax

    model = FlaxResNet50(dtype=jnp.float32)
    variables = jax.jit(lambda key: init_resnet_params(model, key, input_hw=32))(
        jax.random.key(0))
    port = ResNet50(dtype=torch.float32, device="cpu")
    port.load_state_dict(resnet_from_flax(variables))
    return model, variables, port


@pytest.mark.parametrize("n", [8, 5])
@pytest.mark.parametrize("engine", ["flax", "opt"])
def test_feature_fn_mesh_matches_single_device(backbones, rng, n, engine):
    """make_feature_fn(mesh=data 4) on n frames (5: a padded tail) from the
    host: n rows in order, equal to the port's single device at 1e-5 and
    h36x's data-parallel function at the whole network's 2e-3."""
    from h36x.extract.pipeline import make_feature_fn as jax_make_feature_fn
    from h36x_torch.extract.pipeline import make_feature_fn

    model, variables, port = backbones
    frames = np.asarray(rng.integers(0, 256, size=(n, 32, 32, 3)), dtype=np.uint8)
    single = make_feature_fn(port, engine=engine)(torch.from_numpy(frames)).numpy()
    got = make_feature_fn(port, mesh=make_mesh(4, devices=cpus(4)), engine=engine)(frames)
    assert got.shape == (n, 2048) and got.device == CPU
    np.testing.assert_allclose(got.numpy(), single, rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_make_feature_fn(
        model, mesh=jax_mesh.make_mesh(4, 1, devices=jax.devices()[:4]), engine=engine)(
        variables, frames))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def test_metrics_rows_name_the_mesh(store, init_params, tmp_path, capsys):
    """A 2 x 2 mesh's run says how it split and writes h36x's row keys; its
    `tp_train_*` bytes count the local joins."""
    init, _ = init_params
    run_port(store, tmp_path / "m", init, 1, make_mesh(2, 2, devices=cpus(4)))
    out = capsys.readouterr().out
    assert "mesh: data=2, model=2; 13 params split over the model axis" in out
    row = json.loads((tmp_path / "m" / "metrics.jsonl").read_text().splitlines()[0])
    assert set(ROW_KEYS) <= set(row)
    assert row["tp_train_all_gather_bytes"] > 0 and row["tp_train_all_reduce_bytes"] > 0


def test_run_extract_over_local_devices(tmp_path, capsys, monkeypatch):
    """run_extract with two local devices runs the backbone data-parallel
    (h36x's mesh when there is more than one device): the store of one
    device's run, every non-feature array byte-equal and the features
    within 1e-5 by relative norm (the same backbone on other row blocks; a
    float32 one, which the CPU runs faster than bfloat16)."""
    from h36x_torch.config import ExtractConfig
    from h36x_torch.extract import pipeline
    from h36x_torch.models.resnet import ResNet50
    from h36x_torch.utils import runtime
    from tests.test_dedup import FakeOverlapDataset

    monkeypatch.setattr(pipeline, "_load_backbone",
                        lambda cfg, device: ResNet50(dtype=torch.float32, device=device))

    ds = FakeOverlapDataset(n_videos=1, smooth=True)
    kw = dict(seq_len=8, resize=16, batch_size=1, num_workers=1, augment=True,
              shard_size=2, shuffle_pool=100, shuffle_seed=1)
    for name, count in (("one", 1), ("two", 2)):
        # the local device list, as a host of `count` cards gives it
        for module in (pipeline, runtime):
            monkeypatch.setattr(module, "local_devices", lambda device: cpus(count))
        torch.manual_seed(3)
        pipeline.run_extract(ExtractConfig(out=str(tmp_path / name), **kw), dataset=ds,
                             device="cpu")
    assert "Extraction over 2 devices (data-parallel backbone)" in capsys.readouterr().out
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
