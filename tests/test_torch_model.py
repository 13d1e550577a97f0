"""h36x_torch PHD model against h36x: flax param conversion both ways, the
eval forward against PHDFor3DJoints.apply and the fused engine, and the
golden PHD fixtures."""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h36x.infer import phd_forward_fused as jax_fused_forward
from h36x.models.phd import PHDFor3DJoints as FlaxPHD
from h36x_torch.infer import make_fused_forward, phd_forward_fused
from h36x_torch.models.phd import (
    PHDFor3DJoints,
    param_tree,
    params_from_flax,
    params_to_flax,
)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "core_v1.npz"
SMALL = dict(latent_dim=64, feature_dim=32, number_blocks=2, groups=8)


def _flax_params(feats, key=0, **kw):
    model = FlaxPHD(**kw)
    params = jax.jit(model.init)(jax.random.key(key), jnp.asarray(feats))["params"]
    return model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def small():
    """(feats (2, 8, 32), flax model, its params at SMALL), made once."""
    feats = np.random.default_rng(0).normal(size=(2, 8, 32)).astype(np.float32)
    return (feats, *_flax_params(feats, **SMALL))


def _port(flax_params, **kw):
    model = PHDFor3DJoints(**kw, device="cpu")
    model.load_state_dict(params_from_flax(flax_params))
    return model


def test_params_round_trip_bit_for_bit(small):
    _, _, params = small
    back = params_to_flax(_port(params, **SMALL).state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), path


def test_state_dict_names_follow_flax():
    keys = set(PHDFor3DJoints(**SMALL, device="cpu").state_dict())
    for k in ("input_proj.kernel", "f_movie.block0.gn1.scale",
              "f_movie.block1.conv2.kernel", "f_AR.block2.gn2.bias",
              "f_3D.fc1.kernel", "f_3D.fc3.bias"):
        assert k in keys


def test_seeded_init_layout_and_bounds():
    g = torch.Generator().manual_seed(7)
    a = PHDFor3DJoints(**SMALL, generator=g, device="cpu").state_dict()
    b = PHDFor3DJoints(**SMALL, generator=torch.Generator().manual_seed(7),
                       device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["f_movie.block0.conv1.kernel"].shape == (3, 64, 64)
    assert a["f_3D.fc1.kernel"].shape == (64 + 51, 1024)
    assert a["f_3D.fc1.kernel"].abs().max() <= 1 / (64 + 51) ** 0.5
    assert a["f_movie.block0.conv1.kernel"].abs().max() <= 1 / (3 * 64) ** 0.5
    assert torch.equal(a["f_AR.block0.gn1.scale"], torch.ones(64))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_matches_flax_apply(small, use_kernels):
    feats, flax_model, params = small
    apply = jax.jit(functools.partial(flax_model.apply, predict_future=True))
    want = apply({"params": params}, jnp.asarray(feats))
    got = _port(params, **SMALL)(torch.from_numpy(feats), predict_future=True,
                                 use_kernels=use_kernels)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_forward_matches_h36x_fused_engine(small):
    feats, _, params = small
    # jitted: one trace of the interpret-mode Pallas calls instead of one each
    engine = jax.jit(functools.partial(
        jax_fused_forward, predict_future=True, groups=8, use_pallas=True,
        interpret=True))
    want = engine(params, jnp.asarray(feats))
    tparams = param_tree(_port(params, **SMALL))
    got = phd_forward_fused(tparams, torch.from_numpy(feats), True, groups=8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-3, atol=1e-4)
    joints = make_fused_forward(groups=8)(tparams, torch.from_numpy(feats))
    np.testing.assert_allclose(joints.numpy(), np.asarray(want[2]),
                               rtol=1e-3, atol=1e-4)


def test_golden_phd_outputs():
    # tests/test_golden.py::_compute_all: feats from its rng, flax init key 123
    rng = np.random.default_rng(20260816)
    feats = rng.normal(size=(2, 8, 32)).astype(np.float32)
    kw = dict(latent_dim=64, feature_dim=32, number_blocks=2)
    _, params = _flax_params(feats, key=123, **kw)
    phi, phi_hat, joints, _ = _port(params, **kw)(torch.from_numpy(feats))
    golden = np.load(GOLDEN)
    for name, got in (("phd_phi", phi), ("phd_phi_hat", phi_hat),
                      ("phd_joints", joints)):
        np.testing.assert_allclose(got.numpy(), golden[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
