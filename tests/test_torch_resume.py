"""h36x_torch's full checkpoints and --resume on the CPU: the optimizer
state in optax's layout, read back bit for bit by the port and by h36x's
`load_checkpoint`; a layout of another phase refused; stop-after then
--resume equal to the uninterrupted run bit for bit (phases 1 and 2, the
early-stop patience restored); and a `last` written by either package
resumed by the other, the trajectory within rtol 1e-4 of the writer's
uninterrupted run. Small sizes as tests/test_torch_phase2.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h36x.models.phd import PHDFor3DJoints as FlaxPHD
from h36x.train import checkpoint as jax_ckpt
from h36x.train.state import create_train_state
from h36x.train.state import make_optimizer as jax_make_optimizer
from h36x_torch.models.phd import PHDFor3DJoints, params_from_flax
from h36x_torch.train import checkpoint
from h36x_torch.train.state import make_optimizer, optimizer_tensors
from tests.test_torch_phase2 import (  # noqa: F401 (fixtures)
    PHASE2_FLAGS,
    ROW_KEYS,
    SMALL,
    INPUT_LEN,
    T,
    assert_rows_close,
    init_params,
    rows,
    run_h36x,
    run_port,
    store,
)

PHASE2_OPTIM = dict(phase=2, input_len=INPUT_LEN, pred_len=5, curriculum_steps=2)


def _stepped(phase, seed=0):
    """A port model and its AdamW of `phase` after two updates on random
    gradients."""
    model = PHDFor3DJoints(**SMALL, dropout=0.0, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    opt, _ = make_optimizer(model, 1e-3, phase=phase if phase != 1 else None)
    g = torch.Generator().manual_seed(seed + 1)
    for _ in range(2):
        for p in opt.param_groups[0]["params"]:
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
    return model, opt


def test_checkpoint_round_trip_is_exact(tmp_path):
    model, opt = _stepped(1)
    checkpoint.save_checkpoint(tmp_path, "last", model, opt, epoch=2, best_val=1.5,
                               step=9, extra={"no_improve": 1})
    other, oopt = _stepped(1, seed=7)
    manifest = checkpoint.load_checkpoint(tmp_path, "last", other, oopt)
    assert (manifest["epoch"], manifest["step"], manifest["no_improve"]) == (2, 9, 1)
    for a, b in zip(optimizer_tensors(opt), optimizer_tensors(oopt)):
        assert torch.equal(a, b)
    for (name, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), name
    assert oopt.param_groups[0]["lr"] == float(np.float32(1e-3))


@pytest.mark.parametrize("phase", [1, 2, 0])
def test_h36x_restores_the_ports_checkpoint(tmp_path, phase):
    """h36x's load_checkpoint (flax from_bytes into its own TrainState)
    reads the port's blob: params, mu and nu bit for bit, both counts,
    the learning rate, the step; frozen leaves are optax's MaskedNode."""
    model, opt = _stepped(phase)
    checkpoint.save_checkpoint(tmp_path, "last", model, opt, epoch=0, best_val=1.0,
                               step=2)
    tx, frozen = jax_make_optimizer(1e-4, phase=phase if phase != 1 else None)
    flax_model = FlaxPHD(**SMALL, dropout=0.0)
    template = create_train_state(flax_model, tx, jax.random.key(0),
                                  jnp.zeros((2, T, 32)))
    state, _ = jax_ckpt.load_checkpoint(tmp_path, "last", template)
    params = params_from_flax(jax.tree.map(np.asarray, state.params))
    for name, p in model.state_dict().items():
        assert torch.equal(params[name], p), name
    inject = (state.opt_state.inner_states["trainable"].inner_state if frozen
              else state.opt_state)
    adam = inject.inner_state[0]
    assert int(inject.count) == int(adam.count) == 2 and int(state.step) == 2
    np.testing.assert_array_equal(inject.hyperparams["learning_rate"], np.float32(1e-3))
    for key in ("mu", "nu"):
        tree = getattr(adam, key)
        for name, p in model.named_parameters():
            leaf = tree
            for part in name.split("."):
                leaf = leaf[part]
            if name.split(".")[0] in frozen:
                assert not hasattr(leaf, "shape"), name  # MaskedNode
            else:
                assert torch.equal(torch.from_numpy(np.array(leaf)),
                                   opt.state[p][key]), f"{key} {name}"


@pytest.mark.parametrize("written, read, match", [
    (1, 2, "opt_state holds mu of input_proj"),
    (0, 1, "inner_states"),
    (1, 0, "multi_transform"),
])
def test_checkpoint_of_another_phase_raises(tmp_path, written, read, match):
    model, opt = _stepped(written)
    checkpoint.save_checkpoint(tmp_path, "last", model, opt, epoch=0, best_val=1.0,
                               step=2)
    other, oopt = _stepped(read)
    with pytest.raises(ValueError, match=match):
        checkpoint.load_checkpoint(tmp_path, "last", other, oopt)


def test_orbax_checkpoint_raises(tmp_path):
    (tmp_path / "last.json").write_text(json.dumps({"backend": "orbax", "dir": "last.0"}))
    model, opt = _stepped(1)
    with pytest.raises(NotImplementedError, match="orbax"):
        checkpoint.load_checkpoint(tmp_path, "last", model, opt)


@pytest.mark.parametrize("phase_flags", [[], PHASE2_FLAGS], ids=["phase1", "phase2"])
def test_stop_after_then_resume_equals_uninterrupted(store, init_params, tmp_path,
                                                     phase_flags):
    """5 epochs with patience 2 and an unreachable min delta (no_improve 0,
    1, 2: early stop after the third epoch) against stop-after 2 then
    --resume: the same rows and final params, bit for bit, and the same
    early stop, which needs the restored no_improve."""
    init, _ = init_params
    flags = [*phase_flags, "--optim.early-stop-patience", "2",
             "--optim.early-stop-min-delta", "1000"]
    whole, _ = run_port(store, tmp_path / "whole", init, 5, *flags)
    run_port(store, tmp_path / "cut", init, 5, *flags, "--optim.stop-after-epochs", "2")
    assert len(rows(tmp_path / "cut")) == 2
    resumed, _ = run_port(store, tmp_path / "cut", "", 5, *flags,
                          "--resume", str(tmp_path / "cut"))
    got, want = rows(tmp_path / "cut"), rows(tmp_path / "whole")
    assert len(want) == 3
    assert [{k: r[k] for k in ("epoch", *ROW_KEYS)} for r in got] == \
        [{k: r[k] for k in ("epoch", *ROW_KEYS)} for r in want]
    for (name, a), b in zip(whole.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), name
    for d in ("whole", "cut"):
        manifest = json.loads((tmp_path / d / "last.json").read_text())
        assert (manifest["epoch"], manifest["no_improve"]) == (2, 2)


@pytest.mark.parametrize("writer", ["h36x", "port"])
@pytest.mark.parametrize("phase", [1, 2])
def test_last_resumes_across_packages(store, init_params, tmp_path, writer, phase):
    """One package trains 1 of 2 epochs and writes `last`; the other
    resumes it: the resumed second epoch within rtol 1e-4 of the writer's
    uninterrupted 2-epoch run."""
    init, _ = init_params
    optim = PHASE2_OPTIM if phase == 2 else {}
    flags = PHASE2_FLAGS if phase == 2 else []
    if writer == "h36x":
        run_h36x(store, tmp_path / "whole", init, 2, **optim)
        run_h36x(store, tmp_path / "cut", init, 2, stop_after_epochs=1, **optim)
        run_port(store, tmp_path / "resumed", "", 2, *flags,
                 "--resume", str(tmp_path / "cut"))
    else:
        run_port(store, tmp_path / "whole", init, 2, *flags)
        run_port(store, tmp_path / "cut", init, 2, *flags,
                 "--optim.stop-after-epochs", "1")
        run_h36x(store, tmp_path / "resumed", init, 2, resume=tmp_path / "cut", **optim)
    got = rows(tmp_path / "resumed")
    assert [r["epoch"] for r in got] == [1]
    assert_rows_close(got, rows(tmp_path / "whole")[1:], 1e-4)
