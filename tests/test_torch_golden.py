"""h36x_torch against the golden fixtures of tests/golden/ that the port's
other tests do not read: core_v1.npz's projections (pinhole, radial), AR
rollout (rollout_ctx, rollout_future) and crop geometry (crop_box,
resize_wy, resize_wx), at tests/test_golden.py's bounds, and the 8-step
phase-2 trajectory of phase2_traj_v1.npz at tests/test_phase2_golden.py's
set-up and bounds. The model params come from the same flax init as the
fixtures', converted to the port."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h36x.models.phd import PHDFor3DJoints as FlaxPHD
from h36x_torch.models.phd import PHDFor3DJoints, param_tree, params_from_flax, params_to_flax

GOLDEN = pathlib.Path(__file__).parent / "golden"
CORE_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_golden.py
PHASE2_TOL = dict(rtol=2e-4, atol=1e-7)  # tests/test_phase2_golden.py


@pytest.fixture(scope="module")
def core():
    """tests/test_golden.py::_compute_all's inputs, drawn in its order, and
    the fixture."""
    rng = np.random.default_rng(20260816)
    feats = rng.normal(size=(2, 8, 32)).astype(np.float32)
    rng.normal(size=(1, 6, 8)), rng.normal(size=(3, 8, 4)), rng.normal(size=(4,))  # cconv
    pts = rng.normal(size=(5, 17, 3)).astype(np.float32)
    pts[..., 2] = np.abs(pts[..., 2]) + 2.0
    j2d = rng.random((8, 17, 2)).astype(np.float32) * np.array([900, 950]) + 30
    return {"feats": feats, "pts": pts, "j2d": j2d}, np.load(GOLDEN / "core_v1.npz")


def test_golden_projections(core):
    from h36x_torch.geometry.camera import project_point_radial, project_with_K

    inputs, golden = core
    K = torch.tensor([[1145.0, 0, 508.0], [0, 1143.0, 512.0], [0, 0, 1]])
    got = project_with_K(torch.from_numpy(inputs["pts"]), K)
    np.testing.assert_allclose(got.numpy(), golden["pinhole"], **CORE_TOL)
    got = project_point_radial(
        inputs["pts"].reshape(-1, 3) * 100, np.eye(3), np.zeros(3),
        np.array([1100.0, 1102.0]), np.array([500.0, 502.0]),
        np.array([-0.2, 0.24, 0.001, -0.0002, -0.002]))
    np.testing.assert_allclose(got.numpy(), golden["radial"], **CORE_TOL)


def test_golden_rollout(core):
    from h36x_torch.serve import make_rollout_fn

    inputs, golden = core
    model = FlaxPHD(latent_dim=64, feature_dim=32, number_blocks=2)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.key(123), jnp.asarray(inputs["feats"]))["params"])
    port = PHDFor3DJoints(latent_dim=64, feature_dim=32, number_blocks=2, device="cpu")
    port.load_state_dict(params_from_flax(params))
    ctx, fut = make_rollout_fn(param_tree(port), steps=3, groups=32, device="cpu",
                               precise=True)(torch.from_numpy(inputs["feats"]))
    np.testing.assert_allclose(ctx.numpy(), golden["rollout_ctx"], **CORE_TOL)
    np.testing.assert_allclose(fut.numpy(), golden["rollout_future"], **CORE_TOL)


def test_golden_crop_geometry(core):
    from h36x_torch.geometry.crop import compute_square_crop_from_2d
    from h36x_torch.ops.preprocess import crop_resize_matrices

    inputs, golden = core
    box = compute_square_crop_from_2d(inputs["j2d"], 1000, 1000).astype(np.int64)
    np.testing.assert_array_equal(box, golden["crop_box"])
    wy, wx = crop_resize_matrices(box, 1000, 1000, out_size=16)
    np.testing.assert_allclose(wy, golden["resize_wy"], **CORE_TOL)
    np.testing.assert_allclose(wx, golden["resize_wx"], **CORE_TOL)


def _fingerprint(params):
    """tests/test_phase2_golden.py::_param_fingerprint: (mean, std, absmax)
    per leaf in keystr order."""
    rows = []
    for _, leaf in sorted(jax.tree_util.tree_flatten_with_path(params)[0],
                          key=lambda kv: jax.tree_util.keystr(kv[0])):
        x = np.asarray(leaf, np.float64)
        rows.append([x.mean(), x.std(), np.abs(x).max()])
    return np.asarray(rows, np.float64)


def test_golden_phase2_trajectory():
    from h36x_torch.train.state import make_optimizer
    from h36x_torch.train.step import (
        curriculum_horizon,
        make_future_train_step,
        make_weighted_future_eval_step,
    )

    flax_model = FlaxPHD(latent_dim=64, feature_dim=32, number_blocks=1, dropout=0.0)
    params = jax.tree.map(np.asarray, flax_model.init(
        jax.random.key(20260819), jnp.zeros((2, 20, 32)))["params"])
    model = PHDFor3DJoints(latent_dim=64, feature_dim=32, number_blocks=1, dropout=0.0,
                           device="cpu")
    model.load_state_dict(params_from_flax(params))
    optimizer, _ = make_optimizer(model, lr=1e-3, phase=2)

    rng = np.random.default_rng(20260819)
    feats = torch.from_numpy(rng.normal(size=(4, 20, 32)).astype(np.float32))
    j3d = torch.from_numpy((rng.normal(size=(4, 20, 17, 3)) * 0.1).astype(np.float32))
    j2d = torch.from_numpy(rng.normal(size=(4, 20, 17, 2)).astype(np.float32))
    K = torch.eye(3).expand(4, 3, 3).contiguous()
    step = make_future_train_step(model, optimizer, input_len=5, pred_len=10)
    traj = {k: [] for k in ("loss", "l_ar", "l3d", "mpjpe")}
    for i in range(8):
        m = step((feats, j3d, j2d, K), None, curriculum_horizon(i, pred_len=10, steps=4))
        for k in traj:
            traj[k].append(float(m[k]))
    w = torch.ones(4)
    w[-1] = 0.0
    em = make_weighted_future_eval_step(model, input_len=5, pred_len=10)(
        (feats, j3d, j2d, K, w))

    golden = np.load(GOLDEN / "phase2_traj_v1.npz")
    got = {k: np.asarray(v, np.float64) for k, v in traj.items()}
    got["eval"] = np.asarray([float(em[k]) for k in ("loss", "l3d", "mpjpe", "bone", "n")])
    got["fingerprint"] = _fingerprint(params_to_flax(model.state_dict()))
    assert set(golden.files) == set(got)
    for key in golden.files:
        np.testing.assert_allclose(got[key], golden[key], **PHASE2_TOL,
                                   err_msg=f"phase-2 trajectory drifts from the golden '{key}'")
