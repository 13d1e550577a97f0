"""`python -m h36x_torch.cli.train` over local devices on the CPU, the
port's counterpart of tests/test_multiprocess.py::
test_train_cli_two_processes_matches_single:

- one process, `--dist.platform cpu --dist.local-devices 4` (4 virtual
  CPU devices, a data axis of 4) against h36x's same run (its `fit` over
  the 4-device mesh those flags give it) at rtol 1e-5;
- 2 processes x 2 local devices joined by gloo with `--mesh.slices 2`
  (process p holds slice p) against the 4-device single process at rtol
  1e-5, tighter than tests/test_multiprocess.py's 1e-4 (the mean of two
  processes' local means is the 4-device mean up to rounding); rank 0
  logs the 4 global devices, rank 1 writes nothing.

Small sizes and store as tests/test_torch_dist.py; every subprocess under
its own timeout, one thread each."""

import pytest

from h36x_torch.cli.train import main as train_main
from tests.test_torch_dist import (  # noqa: F401 (fixtures)
    assert_rows_close,
    init,
    run_port,
    store,
)
from tests.test_torch_mesh import one_thread, run_h36x  # noqa: F401 (a fixture)
from tests.test_torch_phase2 import ARCH_FLAGS, rows

LOCAL = ("--dist.platform", "cpu", "--dist.local-devices")


@pytest.fixture(scope="module")
def four_devices(store, init, tmp_path_factory):
    """cli.train.main in this process over 4 virtual CPU devices, 2 epochs;
    its outdir and stdout."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("four")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        train_main(["--train-root", str(store), "--train-subjects", "1",
                    "--val-subjects", "5", *ARCH_FLAGS, "--optim.epochs", "2",
                    "--optim.batch-size", "4", "--optim.lr", "1e-3",
                    "--optim.log-every", "0", "--outdir", str(out),
                    "--init-from", str(init), *LOCAL, "4"])
    return out, log.getvalue()


def test_local_devices_cli_matches_h36x(store, init, four_devices, tmp_path):
    import jax

    from h36x.parallel.mesh import make_mesh

    out, log = four_devices
    assert "local devices: 4" in log and "mesh: data=4 (4 local devices)" in log
    run_h36x(store, tmp_path / "jax", init, 2,
             make_mesh(data=4, model=1, devices=jax.devices()[:4]))
    assert_rows_close(rows(out), rows(tmp_path / "jax"), 1e-5)


def test_two_processes_of_two_devices_match_four_devices(store, init, four_devices,
                                                          tmp_path):
    out, _ = four_devices
    logs = run_port(store, tmp_path / "mp", init, 2, *LOCAL, "2", "--mesh.slices", "2")
    assert "Processes: 2 | global devices: 4" in logs[0]
    assert "Phase-1 training" not in logs[1]
    got, want = rows(tmp_path / "mp"), rows(out)
    assert len(got) == len(want) == 2
    assert_rows_close(got, want, 1e-5)
    assert not (tmp_path / "mp_rank1").exists()


@pytest.mark.parametrize("flag", ["--mesh.data", "--mesh.model", "--mesh.slices"])
def test_cli_checks_the_mesh_over_the_devices_setup_finds(store, monkeypatch, flag):
    """cli.train checks the mesh over the devices setup_from_config found,
    as on a host of two cards without --dist.local-devices: the local device
    list comes from `local_devices` (here two CPU devices), and `flag 2`
    passes the check and reaches the trainer with both."""
    import torch

    from h36x_torch.cli import train as cli_train
    from h36x_torch.parallel import distributed

    two = [torch.device("cpu")] * 2
    monkeypatch.setattr(distributed, "local_devices", lambda device, count=0: list(two))
    reached = []
    monkeypatch.setattr(cli_train, "_train", lambda cfg, devices: reached.append(devices))
    train_main(["--train-root", str(store), "--train-subjects", "1", "--val-subjects", "5",
                *ARCH_FLAGS, "--optim.batch-size", "4", "--device", "cpu", flag, "2"])
    assert reached == [two]
