"""h36x_torch.serve against h36x.serve on the CPU: the autoregressive rollout
(context and future joints, and the extended strip buffer), the prefix form
of a rollout step against the masked form, and the streaming predictor,
exact and frozen, push by push and forecast by forecast. Same numpy-seeded
inputs and the same flax params (through `params_from_flax`) on both sides;
small sizes (latent 64, feature 32, G 8, 1-2 blocks, T 8-12). On the CPU the
port runs its plain versions, at precise=True: h36x's CPU products are
float32 (its fast mode is the TPU's single bf16 pass), so float32 is the
mode that matches them to these tolerances. The fast mode's cases are in
tests/test_torch_precision.py.

Tolerances: rtol 1e-3 / atol 1e-4, the forward tolerance of
tests/test_pallas.py widened for the rollout's steps (each step feeds the
next); seen here after 6 steps: max abs difference 1.2e-6 on the future
joints (values up to 3.4) and 4.8e-6 on the strips (values up to 9.8).
Port against model.apply or the numpy oracle: the rtol 1e-4 / atol 1e-5 of
tests/test_serve.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h36x import serve as jax_serve
from h36x.models.phd import PHDFor3DJoints as FlaxPHD
from h36x_torch import serve
from h36x_torch.infer import _regressor, _temporal_net, _temporal_net_masked
from h36x_torch.models.phd import PHDFor3DJoints, param_tree, params_from_flax
from tests.test_serve import _frozen_oracle_forward

TOL = dict(rtol=1e-3, atol=1e-4)  # port vs h36x (see the module docstring)
ORACLE_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_serve.py
SMALL = dict(latent_dim=64, feature_dim=32, number_blocks=1, groups=8)


def _both(feats_shape, seed=0, key=0, **kw):
    """(feats, flax model, flax params (numpy), port param tree on the CPU)."""
    feats = np.random.default_rng(seed).normal(size=feats_shape).astype(np.float32)
    flax_model = FlaxPHD(**kw)
    params = jax.jit(flax_model.init)(jax.random.key(key),
                                      jnp.asarray(feats))["params"]
    params = jax.tree.map(np.asarray, params)
    model = PHDFor3DJoints(**kw, device="cpu")
    model.load_state_dict(params_from_flax(params))
    return feats, flax_model, params, param_tree(model)


@pytest.fixture(scope="module")
def setup():
    return _both((2, 10, 32), **SMALL)


@pytest.fixture(scope="module")
def setup2():
    """Two f_movie blocks, T 8: the rollout comparison's size."""
    return _both((2, 8, 32), seed=1, **{**SMALL, "number_blocks": 2})


def _np(t):
    return t.detach().cpu().numpy()


# -- rollout ------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 3, 6])
def test_rollout_matches_h36x(setup2, steps):
    feats, _, params, tparams = setup2
    want_ctx, want_fut, want_buf = jax_serve._rollout(
        params, jnp.asarray(feats), steps, 17, 8, False)
    ctx, fut, buf = serve._rollout(tparams, torch.from_numpy(feats), steps, 17, 8,
                                   True)
    assert fut.shape == (2, steps, 17, 3) and buf.shape == (2, 8 + steps, 64)
    for name, got, want in (("ctx", ctx, want_ctx), ("future", fut, want_fut),
                            ("phi_ext", buf, want_buf)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL, err_msg=name)
    fn_ctx, fn_fut = serve.make_rollout_fn(tparams, steps, groups=8, device="cpu",
                                           precise=True)(feats)
    j_ctx, j_fut = jax_serve.make_rollout_fn(steps, groups=8)(params, jnp.asarray(feats))
    np.testing.assert_allclose(_np(fn_ctx), np.asarray(j_ctx), **TOL)
    np.testing.assert_allclose(_np(fn_fut), np.asarray(j_fut), **TOL)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("valid_len", [1, 2, 5, 9, 12])
def test_prefix_form_equals_masked_form(setup2, valid_len, use_kernels):
    """f_AR over the prefix buf[:, :v] (what the kernels' path runs; the
    slice keeps the longer buffer's batch stride) equals f_AR over the whole
    buffer with statistics masked to [0, v), at row v - 1."""
    _, _, _, tparams = setup2
    buf = torch.from_numpy(
        np.random.default_rng(3).normal(size=(3, 12, 64)).astype(np.float32))
    prefix = buf[:, :valid_len]
    assert valid_len == 12 or not prefix.is_contiguous()
    got = _temporal_net(prefix, tparams["f_AR"], 8, use_kernels)[:, valid_len - 1]
    want = _temporal_net_masked(buf, tparams["f_AR"], 8, valid_len)[:, valid_len - 1]
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_rollout_needs_cuda_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.make_rollout_fn({}, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.StreamingPredictor({}, window=4)


class TestRollout:
    def test_context_joints_match_model(self, setup):
        feats, flax_model, params, tparams = setup
        ctx, fut = serve.make_rollout_fn(tparams, steps=3, groups=8, device="cpu",
                                         precise=True)(feats)
        want = flax_model.apply({"params": params}, jnp.asarray(feats))[2]
        np.testing.assert_allclose(_np(ctx), np.asarray(want), **ORACLE_TOL)
        assert fut.shape == (2, 3, 17, 3)

    def test_one_step_matches_phi_hat_semantics(self, setup):
        """Rollout step 0 must decode f_AR(phi)[:, -1] — the model's
        next-strip prediction extended one step past the window."""
        feats, _, _, tparams = setup
        _, fut = serve.make_rollout_fn(tparams, steps=1, groups=8, device="cpu",
                                       precise=True)(feats)
        with torch.inference_mode():
            x = serve._project(tparams, torch.from_numpy(feats))
            phi = _temporal_net(x, tparams["f_movie"], 8, False)
            ar = _temporal_net(phi, tparams["f_AR"], 8, False)
            want = _regressor(ar[:, -1:], tparams["f_3D"], 17, False)
        np.testing.assert_allclose(_np(fut), _np(want), **ORACLE_TOL)

    def test_multi_step_prefix_consistency(self, setup):
        """Earlier rollout frames must not change when rolling out further
        (causality of the AR extension)."""
        feats, _, _, tparams = setup
        _, fut2 = serve.make_rollout_fn(tparams, steps=2, groups=8, device="cpu",
                                        precise=True)(feats)
        _, fut5 = serve.make_rollout_fn(tparams, steps=5, groups=8, device="cpu",
                                        precise=True)(feats)
        np.testing.assert_allclose(_np(fut5[:, :2]), _np(fut2), **ORACLE_TOL)

    def test_future_depends_on_context(self, setup):
        feats, _, _, tparams = setup
        rollout = serve.make_rollout_fn(tparams, steps=2, groups=8, device="cpu",
                                        precise=True)
        _, a = rollout(feats)
        _, b = rollout(feats + 1.0)
        assert not np.allclose(_np(a), _np(b))


# -- streaming ------------------------------------------------------------------


def _pair(params, tparams, **kw):
    """The port's predictor (on the CPU) and h36x's, same arguments."""
    return (serve.StreamingPredictor(tparams, device="cpu", precise=True, **kw),
            jax_serve.StreamingPredictor(params, **kw))


class TestStreaming:
    def test_every_push_and_forecast_matches_h36x(self, setup):
        """Cold start, warm-up, sliding past the window, then a forecast."""
        _, _, params, tparams = setup
        stream = np.random.default_rng(4).normal(size=(9, 32)).astype(np.float32)
        sp, jsp = _pair(params, tparams, window=6, feature_dim=32, groups=8)
        for t, feat in enumerate(stream):
            np.testing.assert_allclose(sp.push(feat), jsp.push(feat), **TOL,
                                       err_msg=f"push {t}")
            assert sp.warm == jsp.warm
        np.testing.assert_allclose(sp.forecast(4), jsp.forecast(4), **TOL)

    def test_warm_window_matches_batch_forward(self, setup):
        feats, flax_model, params, tparams = setup
        sp = serve.StreamingPredictor(tparams, window=10, feature_dim=32, groups=8,
                                      device="cpu", precise=True)
        for t in range(10):
            last = sp.push(feats[0, t])
        assert sp.warm
        want = np.asarray(
            flax_model.apply({"params": params}, jnp.asarray(feats[:1]))[2])[0, -1]
        np.testing.assert_allclose(last, want, **ORACLE_TOL)

    def test_cold_start_edge_semantics(self, setup):
        """First push fills the window with the first frame — the prediction
        equals a batch forward over a constant window."""
        feats, flax_model, params, tparams = setup
        sp = serve.StreamingPredictor(tparams, window=10, feature_dim=32, groups=8,
                                      device="cpu", precise=True)
        first = sp.push(feats[0, 0])
        assert not sp.warm
        const = np.broadcast_to(feats[0, 0], (1, 10, 32)).copy()
        want = np.asarray(
            flax_model.apply({"params": params}, jnp.asarray(const))[2])[0, -1]
        np.testing.assert_allclose(first, want, **ORACLE_TOL)

    def test_forecast_shape_and_determinism(self, setup):
        feats, _, _, tparams = setup
        sp = serve.StreamingPredictor(tparams, window=10, feature_dim=32, groups=8,
                                      device="cpu", precise=True)
        for t in range(10):
            sp.push(feats[0, t])
        f1 = sp.forecast(4)
        f2 = sp.forecast(4)
        assert f1.shape == (4, 17, 3) and f1.dtype == np.float32
        np.testing.assert_array_equal(f1, f2)

    def test_forecast_before_push_raises(self, setup):
        _, _, _, tparams = setup
        sp = serve.StreamingPredictor(tparams, window=10, feature_dim=32, groups=8,
                                      device="cpu", precise=True)
        with pytest.raises(RuntimeError):
            sp.forecast(2)

    def test_wrong_feature_width_raises(self, setup):
        _, _, _, tparams = setup
        with pytest.raises(ValueError, match="feature_dim"):
            serve.StreamingPredictor(tparams, window=4, feature_dim=2048, groups=8,
                                     device="cpu")
        sp = serve.StreamingPredictor(tparams, window=4, feature_dim=32, groups=8,
                                      device="cpu", precise=True)
        with pytest.raises(ValueError, match="expected 32"):
            sp.push(np.zeros(31, np.float32))


class TestFrozenStreaming:
    def test_freeze_with_kernel_size_one(self):
        """kernel_size=1 blocks have EMPTY tap history — the slice must be
        (0, D), not the whole window (-(K-1) == -0 pitfall)."""
        kw = dict(latent_dim=32, feature_dim=16, number_blocks=1, groups=4,
                  kernel_size=1)
        feats, _, params, tparams = _both((1, 6, 16), seed=1, **kw)
        sp, jsp = _pair(params, tparams, window=6, feature_dim=16, groups=4)
        for t in range(6):
            sp.push(feats[0, t])
            jsp.push(feats[0, t])
        sp.freeze()
        jsp.freeze()
        for st in sp._frozen[1].values():
            assert st["h"].shape[0] == 0 and st["g"].shape[0] == 0
        new = np.random.default_rng(2).normal(size=(16,)).astype(np.float32)
        out = sp.push(new)
        assert out.shape == (17, 3) and np.isfinite(out).all()
        np.testing.assert_allclose(out, jsp.push(new), **TOL)

    def test_frozen_push_matches_frozen_stats_oracle_and_h36x(self, setup):
        """After freeze(), each O(1) push must equal a full-window forward of
        the frozen-stats model (GN statistics pinned at the freeze window,
        conv history = real frames), the numpy oracle of tests/test_serve.py,
        and h36x's frozen push. Window > receptive field so the oracle's
        left edge padding cannot reach the newest frame."""
        _, _, params, tparams = setup
        rng = np.random.default_rng(5)
        window, extra = 12, 4
        stream = rng.normal(size=(window + extra, 32)).astype(np.float32)
        sp, jsp = _pair(params, tparams, window=window, feature_dim=32, groups=8)
        for t in range(window):
            sp.push(stream[t])
            jsp.push(stream[t])
        sp.freeze()
        jsp.freeze()
        assert sp.frozen
        for name, st in sp._frozen[1].items():
            for key in ("h", "g"):
                np.testing.assert_allclose(_np(st[key]),
                                           np.asarray(jsp._frozen[1][name][key]),
                                           **TOL)
        for m in range(extra):
            got = sp.push(stream[window + m])
            cur = stream[m + 1: window + m + 1]
            want = _frozen_oracle_forward(params, cur, stream[:window], groups=8)
            np.testing.assert_allclose(got, want, **ORACLE_TOL)
            np.testing.assert_allclose(got, jsp.push(stream[window + m]), **TOL)
        np.testing.assert_allclose(sp.forecast(3), jsp.forecast(3), **TOL)

    def test_unfreeze_returns_to_exact(self, setup):
        _, flax_model, params, tparams = setup
        stream = np.random.default_rng(6).normal(size=(14, 32)).astype(np.float32)
        sp = serve.StreamingPredictor(tparams, window=10, feature_dim=32, groups=8,
                                      device="cpu", precise=True)
        for t in range(10):
            sp.push(stream[t])
        sp.freeze()
        sp.push(stream[10])
        sp.unfreeze()
        assert not sp.frozen
        got = sp.push(stream[11])
        want = np.asarray(flax_model.apply(
            {"params": params}, jnp.asarray(stream[2:12][None]))[2])[0, -1]
        np.testing.assert_allclose(got, want, **ORACLE_TOL)

    def test_frozen_push_does_not_rerun_the_temporal_net(self, setup, monkeypatch):
        """The point of the O(1) path: a frozen push never runs the temporal
        net over the window, an exact push does."""
        _, _, _, tparams = setup
        rng = np.random.default_rng(7)
        sp = serve.StreamingPredictor(tparams, window=64, feature_dim=32, groups=8,
                                      device="cpu", precise=True)
        sp.push(rng.normal(size=32).astype(np.float32))
        sp.freeze()
        calls = []
        real = serve._temporal_net
        monkeypatch.setattr(serve, "_temporal_net",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        sp.push(rng.normal(size=32).astype(np.float32))
        assert calls == []
        sp.unfreeze()
        sp.push(rng.normal(size=32).astype(np.float32))
        assert calls == [1]

    def test_freeze_before_push_raises(self, setup):
        _, _, _, tparams = setup
        sp = serve.StreamingPredictor(tparams, window=10, feature_dim=32, groups=8,
                                      device="cpu", precise=True)
        with pytest.raises(RuntimeError):
            sp.freeze()

    def test_forecast_still_works_after_freeze(self, setup):
        feats, _, _, tparams = setup
        sp = serve.StreamingPredictor(tparams, window=10, feature_dim=32, groups=8,
                                      device="cpu", precise=True)
        for t in range(10):
            sp.push(feats[0, t])
        sp.freeze()
        sp.push(feats[1, 0])
        f = sp.forecast(3)
        assert f.shape == (3, 17, 3)
        assert np.all(np.isfinite(f))


class TestRegressorIters:
    """A non-default regressor_iters must flow through every serving entry
    point — a silent fallback to 3 would give systematically wrong joints."""

    def test_threads_through_rollout(self):
        feats, flax_model, params, tparams = _both(
            (2, 10, 32), seed=1, **SMALL, regressor_iters=4)
        want = np.asarray(flax_model.apply({"params": params}, jnp.asarray(feats))[2])
        ctx, _ = serve.make_rollout_fn(tparams, steps=2, groups=8, regressor_iters=4,
                                       device="cpu", precise=True)(feats)
        np.testing.assert_allclose(_np(ctx), want, **ORACLE_TOL)
        # negative control: the default of 3 rounds must NOT reproduce it
        ctx3, _ = serve.make_rollout_fn(tparams, steps=2, groups=8, device="cpu",
                                        precise=True)(feats)
        assert np.abs(_np(ctx3) - want).max() > 1e-4

    def test_threads_through_streaming(self):
        feats, flax_model, params, tparams = _both(
            (1, 6, 32), seed=2, **SMALL, regressor_iters=4)
        want = np.asarray(flax_model.apply({"params": params}, jnp.asarray(feats))[2])
        sp = serve.StreamingPredictor(tparams, window=6, feature_dim=32, groups=8,
                                      regressor_iters=4, device="cpu", precise=True)
        for t in range(6):
            last = sp.push(feats[0, t])
        np.testing.assert_allclose(last, want[0, -1], **ORACLE_TOL)
        sp.freeze()
        assert sp.push(feats[0, 0]).shape == (17, 3)
