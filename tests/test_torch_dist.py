"""h36x_torch's multi-process data-parallel training on the CPU: two
processes of `python -m h36x_torch.cli.train --dist.*` joined by gloo, the
port's counterpart of tests/test_multiprocess.py. The 2-process run holds
h36x's single-process `fit` of the same steps at rtol 1e-5 (dropout 0);
with dropout (and grouped steps) it holds the port's own 1-process run; a
run stopped after 2 of 3 epochs and resumed by a fresh pair holds the
straight run; rank 1 writes nothing. Every subprocess runs under its own
timeout, one thread each. Small sizes as tests/test_torch_phase2.py, on a
store whose val set ends in a batch of 3 rows (padded to 4 across the
two processes, weight 0)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from h36x_torch.config import TrainConfig
from h36x_torch.parallel import distributed
from h36x_torch.parallel.mesh import data_axis_size, make_mesh
from h36x_torch.train.loop import check_supported
from tests.helpers import make_synthetic_store
from tests.test_torch_phase2 import ARCH_FLAGS, ROW_KEYS, T, rows, run_h36x

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds per subprocess


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """7 train clips (subject 1) x 2 variants: 3 batches of 4 an epoch;
    7 val clips (subject 5): batches of 4 and 3."""
    root = tmp_path_factory.mktemp("store")
    make_synthetic_store(root, n_shards=2, clips_per_shard=7, n_vars=2, seq_len=T,
                         feat_dim=32, subjects=(1, 5))
    return root


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """h36x params (a bare flax blob) for --init-from."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from h36x.models.phd import PHDFor3DJoints as FlaxPHD
    from tests.test_torch_phase2 import SMALL

    params = jax.jit(FlaxPHD(**SMALL, dropout=0.0).init)(
        jax.random.key(5), jnp.zeros((2, T, 32)))["params"]
    path = tmp_path_factory.mktemp("init") / "init.msgpack"
    path.write_bytes(serialization.to_bytes(params))
    return path


def run_port(store, outdir, init, epochs, *flags, processes=2):
    """`python -m h36x_torch.cli.train` on the CPU in `processes`
    subprocesses (gloo when 2); returns their logs."""
    argv = [sys.executable, "-m", "h36x_torch.cli.train", "--train-root", str(store),
            "--device", "cpu", "--train-subjects", "1", "--val-subjects", "5",
            *ARCH_FLAGS, "--optim.epochs", str(epochs), "--optim.batch-size", "4",
            "--optim.lr", "1e-3", "--optim.log-every", "0", "--outdir", str(outdir),
            "--init-from", str(init), *flags]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = _free_port()
    # every rank past 0 gets an --outdir of its own, which must stay absent
    rank_flags = ([["--dist.num-processes", str(processes), "--dist.process-id", str(i),
                    "--dist.coordinator", f"localhost:{port}"]
                   + (["--outdir", f"{outdir}_rank{i}"] if i else []) for i in range(processes)]
                  if processes > 1 else [[]])
    procs = [subprocess.Popen(argv + f, cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for f in rank_flags]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {i} failed:\n{log[-4000:]}"
    return logs


def assert_rows_close(got: list, want: list, rtol: float) -> None:
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want]
    for g, w in zip(got, want):
        for key in ROW_KEYS:
            np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                       err_msg=f"epoch {w['epoch']} {key}")


@pytest.fixture(scope="module")
def straight(store, init, tmp_path_factory):
    """The 2-process run of 3 epochs at dropout 0, and its logs."""
    out = tmp_path_factory.mktemp("straight")
    return out, run_port(store, out, init, 3)


def test_two_processes_match_h36x_single_process(store, init, straight, tmp_path):
    """Rows within rtol 1e-5 of h36x's one-process fit of the same steps
    (the mean of two half-batch means is the global mean up to rounding);
    rank 0 logs and writes, rank 1 does neither."""
    out, logs = straight
    run_h36x(store, tmp_path / "jax", init, 3)
    assert_rows_close(rows(out), rows(tmp_path / "jax"), 1e-5)
    assert "Phase-1 training" in logs[0] and "processes: 2" in logs[0]
    assert "Phase-1 training" not in logs[1] and "Epoch" not in logs[1]
    assert sorted(os.listdir(out)) == ["best.json", "best.msgpack", "last.json",
                                       "last.msgpack", "metrics.jsonl"]
    assert not os.path.exists(f"{out}_rank1")


def test_resume_matches_the_straight_run(store, init, straight, tmp_path):
    """Stopped after 2 of 3 epochs, then resumed by a fresh pair of
    processes: every row and the last checkpoint equal the straight run's."""
    out, _ = straight
    legs = tmp_path / "legs"
    run_port(store, legs, init, 3, "--optim.stop-after-epochs", "2")
    assert len(rows(legs)) == 2
    logs = run_port(store, legs, init, 3, "--resume", str(legs))
    assert "Resumed from" in logs[0] and "Resumed" not in logs[1]
    assert not os.path.exists(f"{legs}_rank1")
    assert rows(legs) and [r["epoch"] for r in rows(legs)] == [0, 1, 2]
    for got, want in zip(rows(legs), rows(out)):
        assert {k: got[k] for k in ROW_KEYS} == {k: want[k] for k in ROW_KEYS}
    assert (legs / "last.msgpack").read_bytes() == (out / "last.msgpack").read_bytes()


@pytest.mark.parametrize("flags", [[], ["--optim.grad-accum", "2"],
                                   ["--optim.steps-per-dispatch", "2"]],
                         ids=["ungrouped", "grad_accum", "steps_per_dispatch"])
def test_dropout_two_processes_match_one_process(store, init, tmp_path, flags):
    """At dropout 0.5 each process draws the global batch's masks and keeps
    its rows, so the 2-process run holds the port's 1-process run (rtol
    1e-5), ungrouped and grouped."""
    extra = ("--model.dropout", "0.5", *flags)
    run_port(store, tmp_path / "one", init, 2, *extra, processes=1)
    run_port(store, tmp_path / "two", init, 2, *extra)
    assert_rows_close(rows(tmp_path / "two"), rows(tmp_path / "one"), 1e-5)


def test_local_batch_slice_partitions_and_refuses_an_indivisible_batch():
    for world in (1, 2, 4):
        parts = [distributed.local_batch_slice(8, r, world) for r in range(world)]
        covered = [i for s in parts for i in range(8)[s]]
        assert covered == list(range(8))
    assert distributed.local_batch_slice(6, 1, 2) == slice(3, 6)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.local_batch_slice(5, 0, 2)
    assert distributed.process_info() == (0, 1)
    assert distributed.is_main_process()


def test_mesh_layout_checks():
    assert data_axis_size(make_mesh(n_processes=4)) == 4
    assert data_axis_size(make_mesh(2, 1, slices=2, n_processes=4)) == 4
    assert make_mesh(-1, 1, slices=2, n_processes=4).shape == {
        "slice": 2, "data": 2, "model": 1}
    with pytest.raises(ValueError, match="not divisible by slices"):
        make_mesh(-1, 1, slices=3, n_processes=4)
    with pytest.raises(ValueError, match="!= 4 devices"):
        make_mesh(1, 1, n_processes=4)
    # more devices than processes: 2 processes x 2 local devices, process
    # by process in the mesh's row-major order
    mesh = make_mesh(4, 1, ["cpu", "cpu"], n_processes=2)
    assert [(d.process, d.index) for d in mesh.devices.reshape(-1)] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert mesh.local_groups(0) == [[torch.device("cpu")]] * 2


@pytest.mark.parametrize("field, value", [("mesh.model", 2), ("dist.local_devices", 2)])
def test_tensor_parallel_and_local_devices_raise(field, value):
    """Neither raises any more. A model axis of 2 over 2 processes makes a
    1 x 1 x 2 mesh (with orbax checkpoints; tests/test_torch_tp.py runs it).
    Two local devices per process (the CPU's virtual devices) make a data
    axis of 4 over 2 processes, and one process's setup returns its two
    devices; on CUDA the count is refused (CPU only, as h36x's)."""
    cfg = TrainConfig()
    cfg.dist.num_processes = 2
    head, _, leaf = field.rpartition(".")
    setattr(getattr(cfg, head), leaf, value)
    if field == "mesh.model":
        cfg.ckpt_backend = "orbax"
        assert check_supported(cfg).shape == {"slice": 1, "data": 1, "model": 2}
        assert make_mesh(cfg.mesh.data, cfg.mesh.model, n_processes=2).model == 2
        return
    assert check_supported(cfg).shape == {"slice": 1, "data": 4, "model": 1}
    cfg.dist.num_processes = 1
    try:
        assert distributed.setup_from_config(cfg.dist, "cpu") == [torch.device("cpu")] * 2
        assert distributed.process_devices() == [torch.device("cpu")] * 2
        assert make_mesh().shape == {"slice": 1, "data": 2, "model": 1}
    finally:
        distributed.shutdown()
    assert distributed.process_devices() == [None]
    with pytest.raises(ValueError, match="CPU's virtual device count"):
        distributed.check_local_devices(cfg.dist, "cuda")


def test_batch_must_divide_among_the_processes():
    cfg = TrainConfig()
    cfg.dist.num_processes, cfg.optim.batch_size = 2, 5
    with pytest.raises(ValueError, match="must divide the batch size"):
        check_supported(cfg)
    cfg.optim.batch_size = 4
    check_supported(cfg)


@pytest.mark.parametrize("collectives, platform, match", [
    ("mpi", "", "unknown --dist.collectives"),
    ("nccl", "cpu", "needs CUDA devices"),
    ("", "tpu", "unknown --dist.platform"),
])
def test_setup_refuses_unknown_settings(collectives, platform, match):
    cfg = TrainConfig().dist
    cfg.num_processes, cfg.process_id = 2, 0
    cfg.collectives, cfg.platform = collectives, platform
    with pytest.raises(ValueError, match=match):
        distributed.setup_from_config(cfg, "cpu" if platform != "tpu" else None)
    assert distributed.process_info() == (0, 1)


def test_fit_refuses_a_config_without_its_process_group(store):
    from h36x_torch.train.loop import fit

    cfg = TrainConfig()
    cfg.dist.num_processes, cfg.optim.batch_size = 2, 4
    with pytest.raises(ValueError, match="process group holds 1"):
        fit(cfg, None, None, None, None, device="cpu")
