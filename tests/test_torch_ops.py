"""h36x_torch ops against h36x: the causal conv, the fused temporal op and
the fused regressor, same numpy-seeded inputs through both packages (on the
CPU the port's wrappers run their plain versions; the JAX side runs its
plain reference and its Pallas kernel in interpret mode)."""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h36x.ops.causal_conv import causal_conv1d as jax_cconv
from h36x.ops.pallas_regressor import _reference_forward as jax_reg_ref
from h36x.ops.pallas_regressor import fused_joint_regressor as jax_reg_fused
from h36x.ops.pallas_temporal import fused_gn_relu_cconv as jax_fused
from h36x.ops.pallas_temporal import reference_gn_relu_cconv as jax_ref
from h36x_torch.ops.causal_conv import causal_conv1d
from h36x_torch.ops.regressor import _reference_forward, fused_joint_regressor
from h36x_torch.ops.temporal import (
    fused_gn_relu_cconv,
    fused_residual_block,
    reference_gn_relu_cconv,
)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "core_v1.npz"
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_pallas.py's forward tolerance


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# The JAX side of each case in one jit: the plain reference and the Pallas
# kernel in interpret mode then compile together, once per shape.
@functools.partial(jax.jit, static_argnames=("groups",))
def _jax_temporal(x, scale, bias, w, cb, res, *, groups):
    return (jax_ref(x, scale, bias, w, cb, residual=res, groups=groups),
            jax_fused(x, scale, bias, w, cb, res, groups=groups, tile_o=32,
                      interpret=True))


@functools.partial(jax.jit, static_argnames=("iters",))
def _jax_regressor(phi, w1, b1, w2, b2, w3, b3, *, iters):
    ws = (phi, w1, b1, w2, b2, w3, b3)
    return (jax_reg_ref(*ws, iters, 51),
            jax_reg_fused(*ws, iters, 51, 8, True))


class TestCausalConv:
    @pytest.mark.parametrize("t", [1, 2, 6])
    def test_matches_h36x(self, rng, t):
        x = rng.normal(size=(2, t, 8)).astype(np.float32)
        w = rng.normal(size=(3, 8, 5)).astype(np.float32)
        b = rng.normal(size=(5,)).astype(np.float32)
        got = causal_conv1d(*_t(x, w, b)).numpy()
        want = np.asarray(jax_cconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_golden_cconv(self):
        # the inputs of tests/test_golden.py::_compute_all, drawn in its order
        rng = np.random.default_rng(20260816)
        rng.normal(size=(2, 8, 32))  # the PHD feats come first
        x = rng.normal(size=(1, 6, 8)).astype(np.float32)
        w = rng.normal(size=(3, 8, 4)).astype(np.float32)
        b = rng.normal(size=(4,)).astype(np.float32)
        got = causal_conv1d(*_t(x, w, b)).numpy()
        np.testing.assert_allclose(got, np.load(GOLDEN)["cconv"],
                                   rtol=1e-4, atol=1e-5)


def _temporal_inputs(rng, b=2, t=8, d=64):
    return (
        rng.normal(size=(b, t, d)).astype(np.float32),
        rng.normal(size=(d,)).astype(np.float32),
        rng.normal(size=(d,)).astype(np.float32),
        (rng.normal(size=(3, d, d)) * 0.1).astype(np.float32),
        (rng.normal(size=(d,)) * 0.1).astype(np.float32),
    )


class TestTemporal:
    """The TestFusedTemporal cases of tests/test_pallas.py: b=2, t=8, d=64,
    G=8; short clips; residual; plus valid_len masking."""

    @pytest.mark.parametrize("t", [1, 2, 3, 8])
    @pytest.mark.parametrize("with_residual", [False, True])
    def test_matches_h36x(self, rng, t, with_residual):
        ins = _temporal_inputs(rng, t=t)
        res = rng.normal(size=ins[0].shape).astype(np.float32) if with_residual else None
        got = fused_gn_relu_cconv(*_t(*ins), None if res is None else _t(res)[0],
                                  groups=8).numpy()
        want_ref, want_kernel = _jax_temporal(
            *[jnp.asarray(v) for v in ins], None if res is None else jnp.asarray(res),
            groups=8)
        np.testing.assert_allclose(got, np.asarray(want_ref), **TOL)
        np.testing.assert_allclose(got, np.asarray(want_kernel), **TOL)

    @pytest.mark.parametrize("valid_len", [1, 5, 8])
    def test_valid_len_masking(self, rng, valid_len):
        ins = _temporal_inputs(rng)
        got = reference_gn_relu_cconv(*_t(*ins), groups=8,
                                      valid_len=valid_len).numpy()
        want = np.asarray(jax_ref(*[jnp.asarray(v) for v in ins], groups=8,
                                  valid_len=valid_len))
        # outputs at t >= valid_len are garbage by contract
        np.testing.assert_allclose(got[:, :valid_len], want[:, :valid_len], **TOL)

    def test_residual_block_matches_h36x(self, rng):
        from h36x.ops.pallas_temporal import fused_residual_block as jax_block

        d = 64
        x = rng.normal(size=(2, 8, d)).astype(np.float32)
        p = {}
        for i in (1, 2):
            p[f"gn{i}"] = {"scale": rng.normal(size=(d,)).astype(np.float32),
                           "bias": rng.normal(size=(d,)).astype(np.float32)}
            p[f"conv{i}"] = {
                "kernel": (rng.normal(size=(3, d, d)) * 0.1).astype(np.float32),
                "bias": (rng.normal(size=(d,)) * 0.1).astype(np.float32)}
        tp = {k: {n: torch.from_numpy(v) for n, v in sub.items()} for k, sub in p.items()}
        jp = {k: {n: jnp.asarray(v) for n, v in sub.items()} for k, sub in p.items()}
        got = fused_residual_block(torch.from_numpy(x), tp, groups=8).numpy()
        block = jax.jit(functools.partial(jax_block, groups=8, tile_o=32,
                                          interpret=True))
        want = np.asarray(block(jnp.asarray(x), jp))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)

    def test_cpu_runs_plain_version_without_counting(self, rng):
        before = fused_gn_relu_cconv.launches
        ins = _t(*_temporal_inputs(rng))
        got = fused_gn_relu_cconv(*ins, groups=8)
        want = reference_gn_relu_cconv(*ins, groups=8)
        assert torch.equal(got, want)
        assert fused_gn_relu_cconv.launches == before

    def test_other_device_raises(self, rng):
        ins = [v.to("meta") for v in _t(*_temporal_inputs(rng))]
        with pytest.raises(ValueError, match="cuda or cpu"):
            fused_gn_relu_cconv(*ins, groups=8)


def _regressor_inputs(rng, n=40, d=128, h=64, out=51):
    return (
        rng.normal(size=(n, d)).astype(np.float32),
        (rng.normal(size=(d + out, h)) * 0.1).astype(np.float32),
        (rng.normal(size=(h,)) * 0.1).astype(np.float32),
        (rng.normal(size=(h, h)) * 0.1).astype(np.float32),
        (rng.normal(size=(h,)) * 0.1).astype(np.float32),
        (rng.normal(size=(h, out)) * 0.1).astype(np.float32),
        (rng.normal(size=(out,)) * 0.1).astype(np.float32),
    )


class TestRegressor:
    """The TestFusedRegressor cases of tests/test_pallas.py."""

    @pytest.mark.parametrize("n, iters", [(40, 3), (13, 3), (7, 2)])
    def test_matches_h36x(self, rng, n, iters):
        ins = _regressor_inputs(rng, n=n)
        got = fused_joint_regressor(*_t(*ins), iters, 51).numpy()
        want_ref, want_kernel = _jax_regressor(*[jnp.asarray(v) for v in ins],
                                               iters=iters)
        assert got.shape == (n, 51)
        np.testing.assert_allclose(got, np.asarray(want_ref), **TOL)
        np.testing.assert_allclose(got, np.asarray(want_kernel), **TOL)
        plain = _reference_forward(*_t(*ins), iters, 51).numpy()
        assert np.array_equal(got, plain)

    def test_raises_above_p_pad(self, rng):
        ins = _regressor_inputs(rng, n=4, out=66)
        with pytest.raises(ValueError, match="P_PAD"):
            fused_joint_regressor(*_t(*ins), 3, 66)

    def test_other_device_raises(self, rng):
        ins = [v.to("meta") for v in _t(*_regressor_inputs(rng, n=4))]
        with pytest.raises(ValueError, match="cuda or cpu"):
            fused_joint_regressor(*ins, 3, 51)
