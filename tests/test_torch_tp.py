"""h36x_torch's tensor parallelism over processes (`--mesh.model`) on the
CPU, gloo processes in subprocesses, each under its own timeout, one
thread each:

- the sharding rules split the same dimension of every param as h36x's
  `param_sharding_rules` on the same tree, and leave replicated the same
  indivisible ones;
- two ranks of one model group: the phase-1 and phase-2 gradients of the
  split params, gathered, hold one process's autograd (dropout 0.5, the
  same masks), and the gradients of the replicated params come out equal
  on both ranks, bit for bit;
- `cli.train --mesh.model 2 --ckpt-backend orbax` on 2 processes holds
  h36x's single-process `fit` of the same steps at rtol 1e-5 (dropout 0;
  tests/test_parallel.py holds h36x's own TP mesh against one device);
  rank 1 writes nothing, and h36x reads the run's orbax `last`;
- `--mesh.data 2 --mesh.model 2` on 4 processes holds the port's
  one-process run (dropout 0.5), and a run stopped after one epoch and
  resumed from its orbax `last` equals the straight run; phase 2 with
  gradient accumulation on 2 processes holds one process's;
- the fused step and msgpack checkpoints with a model axis raise, with
  h36x's messages.
Small sizes as tests/test_torch_dist.py, on its store."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from h36x_torch.config import TrainConfig
from h36x_torch.parallel import mesh as port_mesh
from h36x_torch.train.loop import check_supported
from tests.test_torch_dist import (  # noqa: F401 (fixtures)
    ROOT,
    TIMEOUT,
    _free_port,
    assert_rows_close,
    init,
    run_port,
    store,
)
from tests.test_torch_phase2 import PHASE2_FLAGS, ROW_KEYS, SMALL, T, rows, run_h36x

TP = ("--ckpt-backend", "orbax", "--mesh.model", "2")


@pytest.mark.parametrize("model_size", [2, 3])
def test_rules_split_what_h36x_splits(model_size):
    """Every param of the flagship-shaped tree (small widths, 64 divisible
    by 2, not by 3): the same dimension split, the same ones replicated."""
    import jax
    import jax.numpy as jnp

    from h36x.models.phd import PHDFor3DJoints as FlaxPHD
    from h36x.parallel import mesh as jax_mesh

    params = jax.eval_shape(FlaxPHD(**SMALL, dropout=0.0).init, jax.random.key(0),
                            jnp.zeros((2, T, 32)))["params"]
    data = 8 // model_size
    m = jax_mesh.make_mesh(data, model_size, devices=jax.devices()[:data * model_size])
    want = jax_mesh.param_shardings(params, m)
    got = port_mesh.param_shardings(params, port_mesh.Mesh(1, data, model_size))
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    n_split = 0
    for path, sharding in flat_want:
        spec = tuple(sharding.spec)
        dim = spec.index("model") if "model" in spec else None
        node = got
        for k in path:
            node = node[k.key]
        assert node == dim, jax_mesh._key_path_str(path)
        n_split += dim is not None
    assert n_split == (13 if model_size == 2 else 0)
    shards = port_mesh.shard_params(jax.tree.map(lambda s: np.zeros(s.shape), params),
                                    port_mesh.Mesh(1, data, model_size), index=1)
    kernel = shards["f_movie"]["block0"]["conv1"]["kernel"]
    assert kernel.shape == ((3, 64, 32) if model_size == 2 else (3, 64, 64))


GRAD_WORKER = r"""
import sys, torch, numpy as np
torch.set_num_threads(1)
from h36x_torch.models.phd import PHDFor3DJoints
from h36x_torch.parallel import distributed
from h36x_torch.parallel.mesh import make_mesh
from h36x_torch.parallel.tensor import shard_model
from h36x_torch.train.step import grads_and_metrics, future_grads_and_metrics
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
distributed.initialize(f"localhost:{port}", 2, rank)
mesh = make_mesh(1, 2)
distributed.init_groups(mesh)
arch = dict(latent_dim=64, feature_dim=32, number_blocks=1, ar_blocks=1, groups=8,
            regressor_hidden=64, dropout=0.5, device="cpu")
rng = np.random.default_rng(0)
batch = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((4, 8, 32), (4, 8, 17, 3), (4, 8, 17, 2), (4, 3, 3))]
res = {}
for phase in (1, 2):
    def grads(model):
        g = torch.Generator().manual_seed(3)
        if phase == 1:
            m = grads_and_metrics(model, batch, g)
        else:
            m = future_grads_and_metrics(model, batch, g, 3, input_len=3)
        return m, {n: p.grad.clone() for n, p in model.named_parameters()
                   if p.grad is not None}
    ref_metrics, ref = grads(PHDFor3DJoints(**arch, generator=torch.Generator().manual_seed(1)))
    model = PHDFor3DJoints(**arch, generator=torch.Generator().manual_seed(1))
    tp = shard_model(model, mesh)
    metrics, got = grads(model)
    for n in ref:
        full = tp.gather(n, got[n])
        res[f"{phase}/{n}/err"] = float((full - ref[n]).abs().max() / (ref[n].abs().max() + 1e-30))
        if n not in tp.dims:
            res[f"{phase}/{n}/grad"] = got[n].numpy()
    res[f"{phase}/loss"] = np.array([float(metrics["loss"]), float(ref_metrics["loss"])])
    res[f"{phase}/split"] = np.array(len(tp.dims))
np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
distributed.shutdown()
"""


def test_gradients_of_two_model_ranks(tmp_path):
    """Each rank computes one process's gradients (the reference) and its
    tensor-parallel ones on the same batch and masks; the split params'
    gathered gradients hold the reference within 2e-6 of its largest
    entry, and every replicated param's gradient is the same on both
    ranks, bit for bit."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", GRAD_WORKER, str(r), str(port),
                               str(tmp_path / f"r{r}.npz")], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    r0, r1 = (np.load(tmp_path / f"r{r}.npz") for r in range(2))
    for phase in (1, 2):
        assert int(r0[f"{phase}/split"]) == 13
        np.testing.assert_allclose(*r0[f"{phase}/loss"], rtol=1e-6)
        errs = {k: float(r0[k]) for k in r0.files if k.startswith(f"{phase}/")
                and k.endswith("/err")}
        assert len(errs) == (16 if phase == 1 else 24)  # the params its loss reaches
        assert max(errs.values()) < 2e-6, errs
        replicated = [k for k in r0.files if k.startswith(f"{phase}/") and k.endswith("/grad")]
        assert replicated
        for k in replicated:
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.fixture(scope="module")
def tp_run(store, init, tmp_path_factory):
    """The 2-process tensor-parallel run of 3 epochs at dropout 0."""
    out = tmp_path_factory.mktemp("tp")
    return out, run_port(store, out, init, 3, *TP)


def test_two_model_ranks_match_h36x_single_process(store, init, tp_run, tmp_path):
    out, logs = tp_run
    run_h36x(store, tmp_path / "jax", init, 3)
    assert_rows_close(rows(out), rows(tmp_path / "jax"), 1e-5)
    assert "mesh: data=1, model=2" in logs[0] and "Epoch" not in logs[1]
    assert not os.path.exists(f"{out}_rank1")
    last = json.loads((out / "last.json").read_text())
    assert last["backend"] == "orbax" and (out / last["dir"]).is_dir()
    assert not any(name.endswith(".msgpack") for name in os.listdir(out))
    # h36x reads the run's orbax `last`: the full arrays, step 9
    from h36x.train import checkpoint as jax_ckpt

    raw = jax_ckpt.load_params_raw(out / "last")
    assert raw["f_movie"]["block0"]["conv1"]["kernel"].shape == (3, 64, 64)
    assert json.loads((out / "last.json").read_text())["step"] == 9


def test_data_2_model_2_matches_one_process_and_resumes(store, init, tmp_path):
    extra = (*TP, "--mesh.data", "2", "--model.dropout", "0.5")
    run_port(store, tmp_path / "one", init, 3, *extra[:2], "--model.dropout", "0.5",
             processes=1)
    run_port(store, tmp_path / "four", init, 3, *extra, processes=4)
    assert_rows_close(rows(tmp_path / "four"), rows(tmp_path / "one"), 1e-5)
    legs = tmp_path / "legs"
    run_port(store, legs, init, 3, *extra, "--optim.stop-after-epochs", "1", processes=4)
    logs = run_port(store, legs, init, 3, *extra, "--resume", str(legs), processes=4)
    assert "Resumed from" in logs[0]
    assert [r["epoch"] for r in rows(legs)] == [0, 1, 2]
    for got, want in zip(rows(legs), rows(tmp_path / "four")):
        assert {k: got[k] for k in ROW_KEYS} == {k: want[k] for k in ROW_KEYS}


def test_phase2_with_grad_accum_matches_one_process(store, init, tmp_path):
    """Phase 2 (f_AR trained, its convs split) with two microbatches per
    update, eager under tensor parallelism as under data parallelism, at
    dropout 0.5: the 2-process run holds one process's at rtol 1e-5."""
    extra = ("--ckpt-backend", "orbax", "--model.dropout", "0.5", "--optim.grad-accum",
             "2", *PHASE2_FLAGS)
    run_port(store, tmp_path / "one", init, 2, *extra, processes=1)
    run_port(store, tmp_path / "two", init, 2, *extra, "--mesh.model", "2")
    assert_rows_close(rows(tmp_path / "two"), rows(tmp_path / "one"), 1e-5)


@pytest.mark.parametrize("flags, match", [
    ({"ckpt_backend": "msgpack"}, "spans processes"),
    ({"ckpt_backend": "orbax", "fused": True}, "does not support --mesh.model > 1"),
])
def test_a_model_axis_refuses_msgpack_and_the_fused_step(flags, match):
    cfg = TrainConfig()
    cfg.dist.num_processes, cfg.mesh.model = 2, 2
    cfg.ckpt_backend = flags["ckpt_backend"]
    cfg.optim.fused = flags.get("fused", False)
    with pytest.raises(ValueError, match=match):
        check_supported(cfg)
