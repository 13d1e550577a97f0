"""The port's `precise` switch on the CPU, against h36x.

- The fast mode's plain versions of B1 and B3 (bf16 weights, activations
  as bf16 pairs, float32 sums) against h36x's ops run as h36x's own tests
  run them (Pallas in interpret mode, whose CPU products are exact float32,
  so the difference is the port's rounding alone) and against the port's
  float32 plain versions: relative norm within 2^-8 (bf16 weights round to
  about 2^-9 relative each). The precise mode against h36x at the 1e-4 of
  tests/test_pallas.py.
- Which mode each entry point runs: the serving and prediction paths
  default to the fast mode, as h36x serves; training, the trainer's eval and
  the results stage pass precise=True.
- The frozen streaming step over static buffers: push by push equal to the
  step written functionally (statistics expanded and tap histories rebuilt
  on every push, as h36x writes it) and within the rollout tests'
  tolerance of h36x's frozen push, through freeze -> push -> re-freeze ->
  unfreeze, its buffers updated in place.

Small sizes: latent 64, feature 32, G 8, T 6-10, numpy-seeded inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h36x import serve as jax_serve
from h36x.models.phd import PHDFor3DJoints as FlaxPHD
from h36x.ops.pallas_regressor import fused_joint_regressor as jax_reg_fused
from h36x.ops.pallas_temporal import fused_gn_relu_cconv as jax_fused
from h36x_torch import infer, serve
from h36x_torch.models.phd import PHDFor3DJoints, param_tree, params_from_flax
from h36x_torch.ops import regressor as reg_op
from h36x_torch.ops import temporal as tmp_op

TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_pallas.py's forward tolerance
STREAM_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_torch_rollout.py's TOL
BF16_REL_NORM = 2.0 ** -8
SMALL = dict(latent_dim=64, feature_dim=32, number_blocks=1, groups=8)


def _rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@functools.partial(jax.jit, static_argnames=("groups",))
def _jax_temporal(x, scale, bias, w, cb, res, *, groups):
    return jax_fused(x, scale, bias, w, cb, res, groups=groups, tile_o=32,
                     interpret=True, precise=False)


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("t, with_residual", [(1, True), (3, False), (8, True)])
def test_temporal_modes_against_h36x(rng, t, with_residual, precise):
    d = 64
    x = rng.normal(size=(2, t, d)).astype(np.float32)
    scale = rng.normal(size=(d,)).astype(np.float32)
    bias = rng.normal(size=(d,)).astype(np.float32)
    w = (rng.normal(size=(3, d, d)) * 0.1).astype(np.float32)
    cb = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    res = rng.normal(size=(2, t, d)).astype(np.float32) if with_residual else None
    ins = _t(x, scale, bias, w, cb)
    tres = None if res is None else torch.from_numpy(res)
    got = tmp_op.fused_gn_relu_cconv(*ins, tres, groups=8, precise=precise).numpy()
    want = np.asarray(_jax_temporal(*map(jnp.asarray, (x, scale, bias, w, cb)),
                                    None if res is None else jnp.asarray(res),
                                    groups=8))
    f32 = tmp_op.reference_gn_relu_cconv(*ins, tres, groups=8).numpy()
    if precise:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got, f32)
        return
    assert 0 < _rel_norm(got, want) <= BF16_REL_NORM
    assert 0 < _rel_norm(got, f32) <= BF16_REL_NORM
    # the wrapper's plain version is the fast reference, with or without
    # the bf16 copy of the kernel
    np.testing.assert_array_equal(
        got, tmp_op.reference_gn_relu_cconv(*ins, tres, groups=8, precise=False).numpy())
    with_copy = tmp_op.fused_gn_relu_cconv(*ins, tres, groups=8,
                                           kernel_bf16=tmp_op.bf16_kernel(ins[3]))
    np.testing.assert_array_equal(got, with_copy.numpy())


@functools.partial(jax.jit, static_argnames=("iters",))
def _jax_regressor(phi, w1, b1, w2, b2, w3, b3, *, iters):
    return jax_reg_fused(phi, w1, b1, w2, b2, w3, b3, iters, 51, 8, True)


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("n, iters", [(40, 3), (1, 3), (7, 2)])
def test_regressor_modes_against_h36x(rng, n, iters, precise):
    d, h, p = 128, 64, 51
    ins = [rng.normal(size=(n, d)).astype(np.float32),
           (rng.normal(size=(d + p, h)) * 0.1).astype(np.float32),
           (rng.normal(size=(h,)) * 0.1).astype(np.float32),
           (rng.normal(size=(h, h)) * 0.1).astype(np.float32),
           (rng.normal(size=(h,)) * 0.1).astype(np.float32),
           (rng.normal(size=(h, p)) * 0.1).astype(np.float32),
           (rng.normal(size=(p,)) * 0.1).astype(np.float32)]
    tins = _t(*ins)
    got = reg_op.fused_joint_regressor(*tins, iters, p, precise=precise).numpy()
    want = np.asarray(_jax_regressor(*map(jnp.asarray, ins), iters=iters))
    f32 = reg_op._reference_forward(*tins, iters, p).numpy()
    if precise:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got, f32)
        return
    assert 0 < _rel_norm(got, want) <= BF16_REL_NORM
    assert 0 < _rel_norm(got, f32) <= BF16_REL_NORM
    np.testing.assert_array_equal(
        got, reg_op._reference_forward(*tins, iters, p, precise=False).numpy())
    copies = reg_op.bf16_weights(tins[1], tins[3], tins[5])
    assert [tuple(c.shape) for c in copies] == [(d, h), (64, h), (h, h), (h, 64)]
    with_copies = reg_op.fused_joint_regressor(*tins, iters, p, weights_bf16=copies)
    np.testing.assert_array_equal(got, with_copies.numpy())


# -- which mode each entry point runs ------------------------------------------


def _port_model(**kw):
    return PHDFor3DJoints(**SMALL, generator=torch.Generator().manual_seed(0),
                          device="cpu", **kw)


@pytest.fixture
def recorded(monkeypatch):
    """The `precise` flag of every B1 and B3 call, by op."""
    calls = {"b1": [], "b3": []}
    real_b1, real_b3 = tmp_op.fused_gn_relu_cconv, reg_op.fused_joint_regressor

    def b1(*a, precise=False, **k):
        calls["b1"].append(precise)
        return real_b1(*a, precise=precise, **k)

    def b3(*a, precise=False, **k):
        calls["b3"].append(precise)
        return real_b3(*a, precise=precise, **k)

    monkeypatch.setattr(tmp_op, "fused_gn_relu_cconv", b1)
    monkeypatch.setattr(reg_op, "fused_joint_regressor", b3)
    monkeypatch.setattr(infer, "fused_joint_regressor", b3)
    return calls


def _modes(calls):
    return {op: set(flags) for op, flags in calls.items()}


def test_serving_entry_points_default_to_the_fast_mode(recorded, tmp_path):
    from h36x_torch.serve_daemon import build_predict_fn
    from h36x_torch.train import checkpoint as ckpt

    model = _port_model()
    params = param_tree(model)
    feats = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 6, 32))
                             .astype(np.float32))
    infer.make_fused_forward(params, groups=8)(feats)
    infer.phd_forward_fused(params, feats, True, groups=8)
    serve.make_rollout_fn(params, 2, groups=8, device="cpu")(feats)
    sp = serve.StreamingPredictor(params, window=4, feature_dim=32, groups=8,
                                  device="cpu")
    sp.push(feats[0, 0].numpy())
    sp.freeze()
    sp.push(feats[0, 1].numpy())
    sp.forecast(2)
    ckpt.save_params(tmp_path, "best", model.state_dict())
    predict_fn, _ = build_predict_fn(
        model_path=str(tmp_path / "best.msgpack"), seq_len=6, feature_dim=32,
        latent_dim=64, num_blocks=1, groups=8, device="cpu")
    predict_fn(feats.numpy())
    assert _modes(recorded) == {"b1": {False}, "b3": {False}}
    # and each takes precise=True when asked
    recorded["b1"].clear()
    recorded["b3"].clear()
    infer.make_fused_forward(params, groups=8, precise=True)(feats)
    serve.make_rollout_fn(params, 2, groups=8, device="cpu", precise=True)(feats)
    assert _modes(recorded) == {"b1": {True}, "b3": {True}}


def test_serving_engines_make_the_bf16_copies_once(monkeypatch):
    """The engines make the fast mode's weight copies where they take the
    params (infer.serving_params) and hand them to every op call: serving
    casts no weight. The precise engines make none."""
    casts = []
    real_kernel, real_weights = tmp_op.bf16_kernel, reg_op.bf16_weights
    monkeypatch.setattr(tmp_op, "bf16_kernel",
                        lambda *a: casts.append("b1") or real_kernel(*a))
    monkeypatch.setattr(reg_op, "bf16_weights",
                        lambda *a: casts.append("b3") or real_weights(*a))
    given = []
    real_b1, real_b3 = tmp_op.fused_gn_relu_cconv, reg_op.fused_joint_regressor

    def b1(*a, kernel_bf16=None, **k):
        given.append(kernel_bf16 is not None)
        return real_b1(*a, kernel_bf16=kernel_bf16, **k)

    def b3(*a, weights_bf16=None, **k):
        given.append(weights_bf16 is not None)
        return real_b3(*a, weights_bf16=weights_bf16, **k)

    monkeypatch.setattr(tmp_op, "fused_gn_relu_cconv", b1)
    monkeypatch.setattr(infer, "fused_joint_regressor", b3)
    params = param_tree(_port_model())
    feats = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 6, 32))
                             .astype(np.float32))
    convs = 2 * (SMALL["number_blocks"] + 3)  # f_movie's and f_AR's (3 blocks)
    forward = infer.make_fused_forward(params, groups=8)
    rollout = serve.make_rollout_fn(params, 2, groups=8, device="cpu")
    sp = serve.StreamingPredictor(params, window=4, feature_dim=32, groups=8,
                                  device="cpu")
    assert sorted(casts) == sorted(3 * (convs * ["b1"] + ["b3"]))
    del casts[:]
    forward(feats)
    forward(feats)
    rollout(feats)
    for i in range(3):
        sp.push(feats[0, i].numpy())
    sp.freeze()
    sp.push(feats[0, 3].numpy())
    sp.forecast(2)
    assert casts == [] and given and all(given)
    infer.make_fused_forward(params, groups=8, precise=True)
    serve.make_rollout_fn(params, 2, groups=8, device="cpu", precise=True)
    serve.StreamingPredictor(params, window=4, feature_dim=32, groups=8, device="cpu",
                             precise=True)
    assert casts == []


def test_predict_cli_defaults_to_the_fast_mode(recorded, tmp_path):
    from h36x_torch.cli.predict import main as predict_main
    from h36x_torch.train import checkpoint as ckpt
    from tests.helpers import make_synthetic_store

    store = tmp_path / "store"
    store.mkdir()
    make_synthetic_store(store, n_shards=1, clips_per_shard=2, n_vars=1, seq_len=6,
                         feat_dim=32, subjects=(9,))
    ckpt.save_params(tmp_path, "best", _port_model().state_dict(),
                     config={"model": {"latent_dim": 64, "feature_dim": 32,
                                       "num_blocks": 1, "groups": 8},
                             "data": {"seq_len": 6}})
    argv = ["--features-root", str(store), "--model-path", str(tmp_path / "best.msgpack"),
            "--subjects", "9", "--clips", "1", "--forecast", "2", "--device", "cpu",
            "--out", str(tmp_path / "p.npz")]
    predict_main(argv, use_kernels=True)
    predict_main([*argv, "--streaming", "--freeze"], use_kernels=True)
    assert _modes(recorded) == {"b1": {False}, "b3": {False}}


def test_training_and_results_paths_pass_precise(recorded):
    from h36x_torch.train.step import grads_and_metrics, make_weighted_eval_step

    model = _port_model(dropout=0.0)
    rng = np.random.default_rng(1)
    batch = (torch.from_numpy(rng.normal(size=(2, 6, 32)).astype(np.float32)),
             torch.from_numpy(rng.normal(size=(2, 6, 17, 3)).astype(np.float32)),
             torch.from_numpy(rng.normal(size=(2, 6, 17, 2)).astype(np.float32)),
             torch.eye(3).expand(2, 3, 3).contiguous(),
             torch.ones(2))
    grads_and_metrics(model, batch[:4], torch.Generator().manual_seed(0), fused=True)
    make_weighted_eval_step(model)(batch)  # the trainer's eval and evaluate_test's
    model(batch[0])  # the model's own forward
    assert _modes(recorded) == {"b1": {True}, "b3": {True}}
    assert len(recorded["b1"]) == 3 * 2 * SMALL["number_blocks"] + 2 * 3


# -- the frozen step over static buffers ---------------------------------------


def _functional_frozen_push(params, stats, state, feat, groups, precise):
    """h36x's frozen push written functionally (h36x/serve.py
    _frozen_step_jit): per-group statistics expanded on every push, tap
    histories rebuilt by concatenation. Returns (joints (J, 3), new state)."""
    rep = params["input_proj"]["kernel"].shape[1] // groups
    u = serve._project(params, feat)[None, :]
    new_state = {}
    for name in infer.sorted_blocks(params["f_movie"]):
        p, st, fs = params["f_movie"][name], state[name], stats[name]
        mean1, rstd1 = fs["mu1"].repeat_interleave(rep), fs["rstd1"].repeat_interleave(rep)
        mean2, rstd2 = fs["mu2"].repeat_interleave(rep), fs["rstd2"].repeat_interleave(rep)
        h = torch.relu((u - mean1) * rstd1 * p["gn1"]["scale"] + p["gn1"]["bias"])
        h_hist = torch.cat([st["h"], h], dim=0)
        c1 = torch.einsum("kd,kdo->o", h_hist, p["conv1"]["kernel"])[None, :] \
            + p["conv1"]["bias"]
        g = torch.relu((c1 - mean2) * rstd2 * p["gn2"]["scale"] + p["gn2"]["bias"])
        g_hist = torch.cat([st["g"], g], dim=0)
        c2 = torch.einsum("kd,kdo->o", g_hist, p["conv2"]["kernel"])[None, :] \
            + p["conv2"]["bias"]
        new_state[name] = {"h": h_hist[1:], "g": g_hist[1:]}
        u = c2 + u
    joints = infer._regressor(u[:, None, :], params["f_3D"], 17, True, 3, precise)
    return joints[0, 0], new_state


@pytest.mark.parametrize("precise", [True, False])
def test_static_buffer_frozen_step_equals_the_functional_one_and_h36x(precise):
    feats = np.random.default_rng(8).normal(size=(1, 10, 32)).astype(np.float32)
    flax_model = FlaxPHD(**{**SMALL, "number_blocks": 2})
    fparams = jax.tree.map(np.asarray, jax.jit(flax_model.init)(
        jax.random.key(0), jnp.asarray(feats))["params"])
    model = PHDFor3DJoints(**{**SMALL, "number_blocks": 2}, device="cpu")
    model.load_state_dict(params_from_flax(fparams))
    params = param_tree(model)
    kw = dict(window=10, feature_dim=32, groups=8)
    sp = serve.StreamingPredictor(params, device="cpu", precise=precise, **kw)
    jsp = jax_serve.StreamingPredictor(fparams, **kw)
    stream = np.random.default_rng(9).normal(size=(50, 32)).astype(np.float32)
    ref = None  # the functional step's (stats, state)
    for i, feat in enumerate(stream):
        if i in (10, 30):  # freeze, then re-freeze on a newer window
            sp.freeze()
            jsp.freeze()
            with torch.inference_mode():
                _, stats, state = serve._capture_freeze(sp._xbuf, params["f_movie"], 8,
                                                        1e-5)
            ref = (stats, state)
            ptrs = (sp._xbuf.data_ptr(),
                    [st["h"].data_ptr() for st in sp._frozen[1].values()])
        if i == 40:
            sp.unfreeze()
            jsp.unfreeze()
            ref = None
        got = sp.push(feat)
        want = jsp.push(feat)
        if precise:
            np.testing.assert_allclose(got, want, **STREAM_TOL, err_msg=f"push {i}")
        else:
            assert _rel_norm(got, want) <= 2.0 ** -6, f"push {i}"
        if ref is not None:
            with torch.inference_mode():
                joints, state = _functional_frozen_push(
                    params, ref[0], ref[1], torch.from_numpy(feat), 8, precise)
            ref = (ref[0], state)
            np.testing.assert_array_equal(got, joints.numpy(), err_msg=f"push {i}")
            # the buffers the step updates are the ones freeze() made
            assert ptrs == (sp._xbuf.data_ptr(),
                            [st["h"].data_ptr() for st in sp._frozen[1].values()])
    assert not sp.frozen and sp._io is None
    got, want = sp.forecast(3), jsp.forecast(3)
    if precise:
        np.testing.assert_allclose(got, want, **STREAM_TOL)
    else:
        assert _rel_norm(got, want) <= 2.0 ** -6
