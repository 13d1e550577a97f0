"""h36x_torch's orbax checkpoints (`--ckpt-backend orbax`) against h36x's
orbax.checkpoint on the CPU. The port reads and writes them with its own
OCDBT, zarr and zstd code, which this test holds against tensorstore and
orbax (present on this host only):

- the OCDBT reader equals tensorstore on stores with interior b-tree
  nodes, inline and indirect values, compressed and plain; tensorstore
  reads the port's writer;
- h36x's `save_checkpoint_orbax` of a TrainState is restored by the
  port's `load_checkpoint` bit for bit (params, mu, nu, counts, the
  learning rate, step, manifest), and the port's save by h36x's, in the
  three phases' optimizer layouts;
- a save sharded over a data 4 x model 2 mesh of the 8 virtual CPU devices
  (one zarr chunk per shard) reads back whole;
- the slot cases of tests/test_train_step.py: slots alternate on
  same-parity epochs, a dangling "dir" raises, a newer orbax save is not
  shadowed by an older msgpack one, `--init-from` reads an orbax directory;
- the golden directory tests/golden/orbax_v1 (scripts/make_orbax_golden.py)
  equals tests/golden/orbax_v1.npz through both packages;
- `cli.doctor --ckpt` on an orbax run reports its arrays and CRCs, and
  fails on a corrupted node.
Small sizes as tests/test_torch_resume.py."""

import json
import os
import random
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from h36x.models.phd import PHDFor3DJoints as FlaxPHD
from h36x.parallel.mesh import make_mesh as jax_make_mesh
from h36x.parallel.mesh import shard_params as jax_shard_params
from h36x.train import checkpoint as jax_ckpt
from h36x.train.state import TrainState, create_train_state
from h36x.train.state import make_optimizer as jax_make_optimizer
from h36x_torch.models.phd import PHDFor3DJoints, params_from_flax
from h36x_torch.train import checkpoint
from h36x_torch.utils import ocdbt, zarr_lite
from tests.test_torch_phase2 import SMALL, T
from tests.test_torch_resume import _stepped

GOLDEN = Path(__file__).parent / "golden"


# -- the OCDBT store ------------------------------------------------------------------


@pytest.mark.parametrize("node_bytes, inline, zstd_level", [
    (150, 10, None), (400, 0, 3), (100_000, 100, 9)])
def test_ocdbt_reader_equals_tensorstore(tmp_path, node_bytes, inline, zstd_level):
    """Three commits of random keys and values under small node limits (a
    b-tree several levels deep); the newest version read equal."""
    import tensorstore as ts

    cfg = {"max_decoded_node_bytes": node_bytes, "max_inline_value_bytes": inline,
           "compression": None if zstd_level is None else {"id": "zstd",
                                                          "level": zstd_level}}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": cfg}).result()
    rnd = random.Random(node_bytes)
    for _ in range(3):
        txn = ts.Transaction()
        for _ in range(rnd.randint(20, 60)):
            key = "".join(rnd.choice("ab/.0") for _ in range(rnd.randint(1, 12)))
            kv.with_transaction(txn).write(key.encode(),
                                           os.urandom(rnd.randint(0, 60))).result()
        txn.commit_async().result()
    want = {k: kv.read(k).result().value for k in kv.list().result()}
    store = ocdbt.Store(tmp_path)
    assert store.read_all() == want
    assert store.checked > 1


def test_tensorstore_reads_the_ports_store(tmp_path):
    import tensorstore as ts

    rnd = random.Random(1)
    items = {f"k{i:03d}/{rnd.random()}".encode(): os.urandom(rnd.choice([0, 7, 1024, 1025, 9000]))
             for i in range(120)}
    ocdbt.write_store(tmp_path, items)
    for root in (tmp_path, tmp_path / "ocdbt.process_0"):
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}"}).result()
        assert {k: kv.read(k).result().value for k in kv.list().result()} == items
    assert ocdbt.Store(tmp_path).read_all() == items


def test_a_corrupted_node_raises(tmp_path):
    items = {b"a": b"x" * 5000, b"b": b"y"}
    ocdbt.write_store(tmp_path, items)
    node = next((tmp_path / "d").iterdir())
    blob = bytearray(node.read_bytes())
    blob[20] ^= 1
    node.write_bytes(bytes(blob))
    with pytest.raises(ocdbt.Corrupt, match="CRC-32C"):
        ocdbt.Store(tmp_path).read_all()


# -- TrainStates across the packages --------------------------------------------------


def _h36x_state(phase, seed=3):
    """h36x's TrainState of `phase` after two optax updates on random
    gradients (mu, nu and the counts not zero), step 2."""
    tx, frozen = jax_make_optimizer(1e-3, phase=phase if phase != 1 else None)
    state = create_train_state(FlaxPHD(**SMALL, dropout=0.0), tx, jax.random.key(seed),
                               jnp.zeros((2, T, 32)))
    params, opt_state = state.params, state.opt_state
    rng = np.random.default_rng(seed)
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape),
                                                   jnp.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return TrainState(params, opt_state, jnp.asarray(2, jnp.int32)), tx, frozen


def _assert_port_holds(model, opt, state, frozen):
    params = params_from_flax(jax.tree.map(np.asarray, state.params))
    for name, p in model.state_dict().items():
        assert torch.equal(params[name], p), name
    inject = (state.opt_state.inner_states["trainable"].inner_state if frozen
              else state.opt_state)
    adam = inject.inner_state[0]
    assert int(opt.count) == int(adam.count) == int(inject.count)
    assert float(opt.hyper["lr"]) == float(inject.hyperparams["learning_rate"])
    for key in ("mu", "nu"):
        for name, p in model.named_parameters():
            leaf = getattr(adam, key)
            for part in name.split("."):
                leaf = leaf[part]
            if name.split(".")[0] in frozen:
                assert not hasattr(leaf, "shape"), name  # MaskedNode
            else:
                assert torch.equal(torch.from_numpy(np.array(leaf)),
                                   opt.state[p][key]), f"{key} {name}"


@pytest.mark.parametrize("phase", [1, 2, 0])
def test_port_restores_h36x_orbax_checkpoint(tmp_path, phase):
    state, _, frozen = _h36x_state(phase)
    jax_ckpt.save_checkpoint_orbax(tmp_path, "last", state, epoch=3, best_val=0.25,
                                   config={"note": "h36x"}, extra={"no_improve": 2})
    model, opt = _stepped(phase, seed=9)
    manifest = checkpoint.load_checkpoint(tmp_path, "last", model, opt)
    assert (manifest["epoch"], manifest["step"], manifest["no_improve"]) == (3, 2, 2)
    assert (manifest["backend"], manifest["dir"]) == ("orbax", "last.0")
    _assert_port_holds(model, opt, state, frozen)
    raw = checkpoint.load_params_raw(tmp_path / "last")
    want = jax.tree.map(np.asarray, state.params)
    for a, b in zip(jax.tree.leaves(raw), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("phase", [1, 2, 0])
def test_h36x_restores_the_ports_orbax_checkpoint(tmp_path, phase):
    """h36x's load_checkpoint (orbax.checkpoint with its TrainState as the
    template) and its template-free load_params_raw read the port's
    directory bit for bit."""
    model, opt = _stepped(phase)
    path = checkpoint.save_checkpoint_orbax(tmp_path, "last", model, opt, epoch=4,
                                            best_val=0.5, step=2, config={"x": 1})
    assert path == (tmp_path / "last.0").absolute() and path.is_dir()
    assert not (tmp_path / "last.msgpack").exists()
    tx, frozen = jax_make_optimizer(1e-4, phase=phase if phase != 1 else None)
    template = create_train_state(FlaxPHD(**SMALL, dropout=0.0), tx, jax.random.key(0),
                                  jnp.zeros((2, T, 32)))
    state, manifest = jax_ckpt.load_checkpoint(tmp_path, "last", template)
    assert (manifest["epoch"], manifest["backend"], manifest["dir"]) == (4, "orbax", "last.0")
    assert int(state.step) == 2
    _assert_port_holds(model, opt, state, frozen)
    raw = jax_ckpt.load_params_raw(tmp_path / "last")
    for name, p in model.state_dict().items():
        assert torch.equal(params_from_flax(raw)[name], p), name


def test_port_reads_a_save_sharded_over_data_4_model_2(tmp_path):
    """The params placed on h36x's data 4 x model 2 mesh of the 8 virtual
    CPU devices: orbax writes one chunk per shard, the port reassembles
    every array."""
    state, _, _ = _h36x_state(1)
    mesh = jax_make_mesh(4, 2)
    sharded = TrainState(jax_shard_params(state.params, mesh), state.opt_state, state.step)
    jax_ckpt.save_checkpoint_orbax(tmp_path, "best", sharded, epoch=0, best_val=1.0)
    kv = ocdbt.Store(tmp_path / "best.0").read_all()
    meta = json.loads(kv[b"params.f_movie.block0.conv1.kernel/.zarray"])
    assert meta["shape"] == [3, 64, 64] and meta["chunks"][-1] == 32  # split on model
    chunks = [k for k in kv if k.startswith(b"params.f_movie.block0.conv1.kernel/0.")]
    assert len(chunks) > 2 and b"params.f_movie.block0.conv1.kernel/0.0.1" in kv
    raw = checkpoint.load_params_raw(tmp_path / "best")
    want = jax.tree.map(np.asarray, state.params)
    assert jax.tree.structure(raw) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(raw), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


# -- the slot scheme ------------------------------------------------------------------


def test_slots_alternate_on_same_parity_epochs(tmp_path):
    model, opt = _stepped(1)
    checkpoint.save_checkpoint_orbax(tmp_path, "best", model, opt, 0, 0.9, 1)
    m1 = json.loads((tmp_path / "best.json").read_text())
    checkpoint.save_checkpoint_orbax(tmp_path, "best", model, opt, 2, 0.5, 1)
    m2 = json.loads((tmp_path / "best.json").read_text())
    assert m1["dir"] != m2["dir"]
    assert (tmp_path / m1["dir"]).is_dir() and (tmp_path / m2["dir"]).is_dir()
    # a fresh process (counter reset) seeds from the manifest: not the live slot
    checkpoint._slot_counters.clear()
    checkpoint.save_checkpoint_orbax(tmp_path, "best", model, opt, 4, 0.4, 1)
    assert json.loads((tmp_path / "best.json").read_text())["dir"] != m2["dir"]
    # h36x's counter seeds from the port's manifest the same way
    state, _, _ = _h36x_state(1)
    jax_ckpt._slot_counters.clear()
    live = json.loads((tmp_path / "best.json").read_text())["dir"]
    jax_ckpt.save_checkpoint_orbax(tmp_path, "best", state, 5, 0.3)
    assert json.loads((tmp_path / "best.json").read_text())["dir"] != live


def test_a_dangling_dir_raises(tmp_path):
    model, opt = _stepped(1)
    checkpoint.save_checkpoint(tmp_path, "last", model, opt, 1, 0.9, 2)
    checkpoint.save_checkpoint_orbax(tmp_path, "last", model, opt, 2, 0.8, 2)
    shutil.rmtree(tmp_path / json.loads((tmp_path / "last.json").read_text())["dir"])
    with pytest.raises(FileNotFoundError, match="stale msgpack"):
        checkpoint.load_checkpoint(tmp_path, "last", *_stepped(1, seed=4))


def test_a_newer_orbax_save_is_not_shadowed_by_an_older_msgpack(tmp_path):
    old, oopt = _stepped(1, seed=1)
    checkpoint.save_checkpoint(tmp_path, "last", old, oopt, 10, 0.5, 2)
    new, nopt = _stepped(1, seed=2)
    checkpoint.save_checkpoint_orbax(tmp_path, "last", new, nopt, 20, 0.4, 2)
    assert (tmp_path / "last.msgpack").exists()  # the stale file remains
    model, opt = _stepped(1, seed=3)
    manifest = checkpoint.load_checkpoint(tmp_path, "last", model, opt)
    assert manifest["epoch"] == 20
    for (name, a), b in zip(model.state_dict().items(), new.state_dict().values()):
        assert torch.equal(a, b), name


def test_init_from_reads_an_orbax_directory(tmp_path):
    model, opt = _stepped(1)
    checkpoint.save_checkpoint_orbax(tmp_path, "best", model, opt, 0, 1.0, 2)
    fresh = PHDFor3DJoints(**SMALL, dropout=0.0, device="cpu")
    assert checkpoint.checkpoint_ref_exists(tmp_path / "best")
    for ref in (tmp_path / "best", tmp_path / "best.0"):
        got = checkpoint.load_params_only(ref, fresh.state_dict())
        for name, p in model.state_dict().items():
            assert torch.equal(got[name], p), name


# -- the golden directory -------------------------------------------------------------


def _golden_leaf(tree, path):
    for k in path.split("/"):
        if hasattr(tree, "_asdict"):  # optax's NamedTuple states
            tree = tree._asdict()[k]
        elif isinstance(tree, (list, tuple)):
            tree = tree[int(k)]
        else:
            tree = tree[k]
    return tree


def test_golden_orbax_directory_through_both_packages():
    """tests/golden/orbax_v1 (written by h36x, scripts/make_orbax_golden.py):
    h36x's load_checkpoint and the port's reader both give the npz's
    arrays bit for bit, and the port restores it into a model of the
    recorded architecture."""
    want = np.load(GOLDEN / "orbax_v1.npz")
    cfg = checkpoint.load_recorded_model_config(GOLDEN / "orbax_v1" / "last")
    arch = dict(latent_dim=cfg["latent_dim"], feature_dim=cfg["feature_dim"],
                number_blocks=cfg["num_blocks"], ar_blocks=cfg["ar_num_blocks"],
                groups=cfg["groups"], regressor_hidden=cfg["regressor_hidden"])
    tx, _ = jax_make_optimizer(1e-4)
    template = create_train_state(FlaxPHD(**arch, dropout=0.0), tx, jax.random.key(0),
                                  jnp.zeros((2, T, arch["feature_dim"])))
    state, manifest = jax_ckpt.load_checkpoint(GOLDEN / "orbax_v1", "last", template)
    assert manifest["dir"] == "last.0"
    port_tree = zarr_lite.read_tree(GOLDEN / "orbax_v1" / "last.0")
    for key in want.files:
        a = np.asarray(_golden_leaf(state._asdict(), key))
        b = _golden_leaf(port_tree, key)
        for got in (a, b):
            assert got.dtype == want[key].dtype and got.shape == want[key].shape, key
            np.testing.assert_array_equal(got, want[key], err_msg=key)
    model = PHDFor3DJoints(**arch, dropout=0.0, device="cpu")
    opt = _stepped.__globals__["make_optimizer"](model, 1e-4)[0]
    checkpoint.load_checkpoint(GOLDEN / "orbax_v1", "last", model, opt)
    for name, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), want["params/" + name.replace(".", "/")])


def test_doctor_reports_an_orbax_run_and_fails_a_corrupted_one(tmp_path, capsys):
    from h36x_torch.cli.doctor import main

    model, opt = _stepped(1)
    checkpoint.save_checkpoint_orbax(tmp_path, "last", model, opt, 0, 1.0, 2)
    main(["--device", "cpu", "--ckpt", str(tmp_path)])  # returns: every check passed
    out = capsys.readouterr().out
    assert "orbax last.0" in out and "CRC-32C verified" in out
    node = next((tmp_path / "last.0" / "d").iterdir())
    blob = bytearray(node.read_bytes())
    blob[-1] ^= 0xFF
    node.write_bytes(bytes(blob))
    with pytest.raises(SystemExit, match="checkpoint"):
        main(["--device", "cpu", "--ckpt", str(tmp_path)])
    assert "CRC-32C" in capsys.readouterr().out
