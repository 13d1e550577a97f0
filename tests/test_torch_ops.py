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
                                  groups=8, precise=True).numpy()
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
        got = fused_residual_block(torch.from_numpy(x), tp, groups=8,
                                   precise=True).numpy()
        block = jax.jit(functools.partial(jax_block, groups=8, tile_o=32,
                                          interpret=True))
        want = np.asarray(block(jnp.asarray(x), jp))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)

    def test_cpu_runs_plain_version_without_counting(self, rng):
        before = fused_gn_relu_cconv.launches
        ins = _t(*_temporal_inputs(rng))
        got = fused_gn_relu_cconv(*ins, groups=8)  # precise=False, h36x's default
        want = reference_gn_relu_cconv(*ins, groups=8, precise=False)
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
        got = fused_joint_regressor(*_t(*ins), iters, 51, precise=True).numpy()
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


# -- gradients: the port's autograd against jax.grad through the JAX ops'
# custom_vjp (their Pallas backward kernels in interpret mode; the JAX op
# itself takes its XLA vjp for T <= K) ------------------------------------
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_pallas.py's gradient tolerance


@functools.partial(jax.jit, static_argnames=("groups", "has_res"))
def _jax_temporal_grads(x, scale, bias, w, cb, res, gout, *, groups, has_res):
    def loss(*a):
        out = jax_fused(*a[:5], a[5] if has_res else None, groups=groups,
                        tile_o=32, interpret=True)
        return jnp.sum(out * gout)

    return jax.grad(loss, argnums=tuple(range(6 if has_res else 5)))(
        x, scale, bias, w, cb, res)


def _torch_grads(fn, arrays, gout, **kw):
    leaves = [torch.from_numpy(np.asarray(a)).requires_grad_() for a in arrays]
    out = fn(*leaves, **kw)
    return torch.autograd.grad(out, leaves, torch.from_numpy(gout))


@pytest.mark.parametrize("b, t, with_residual", [
    (2, 8, True), (2, 8, False), (2, 1, True), (2, 2, False), (2, 3, True),
    (5, 9, False),  # batch accumulation of the weight grads
])
def test_temporal_grads_match_h36x(rng, b, t, with_residual):
    ins = list(_temporal_inputs(rng, b=b, t=t))
    if with_residual:
        ins.append(rng.normal(size=ins[0].shape).astype(np.float32))
    gout = rng.normal(size=(b, t, 64)).astype(np.float32)
    want = _jax_temporal_grads(*[jnp.asarray(v) for v in ins[:5]],
                               jnp.asarray(ins[5]) if with_residual else None,
                               jnp.asarray(gout), groups=8, has_res=with_residual)
    got = _torch_grads(fused_gn_relu_cconv, ins, gout, groups=8, precise=True)
    for name, a, w in zip(("dx", "dscale", "dbias", "dW", "dcb", "dres"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


@functools.partial(jax.jit, static_argnames=("iters",))
def _jax_regressor_grads(phi, w1, b1, w2, b2, w3, b3, gout, *, iters):
    def loss(*a):
        return jnp.sum(jax_reg_fused(*a, iters, 51, 8, True) * gout)

    return jax.grad(loss, argnums=tuple(range(7)))(phi, w1, b1, w2, b2, w3, b3)


@pytest.mark.parametrize("n", [40, 13])
def test_regressor_grads_match_h36x(rng, n):
    ins = _regressor_inputs(rng, n=n)
    gout = rng.normal(size=(n, 51)).astype(np.float32)
    want = _jax_regressor_grads(*[jnp.asarray(v) for v in ins], jnp.asarray(gout),
                                iters=3)
    got = _torch_grads(fused_joint_regressor, ins, gout, iters=3, out_dim=51,
                       precise=True)
    for name, a, w in zip(("dphi", "dw1", "db1", "dw2", "db2", "dw3", "db3"),
                          got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL, err_msg=name)


def test_residual_block_dropout_mask_between_the_calls(rng):
    d = 64
    x = torch.from_numpy(rng.normal(size=(2, 8, d)).astype(np.float32))
    p = {}
    for i in (1, 2):
        p[f"gn{i}"] = {"scale": torch.ones(d), "bias": torch.zeros(d)}
        p[f"conv{i}"] = {
            "kernel": torch.from_numpy((rng.normal(size=(3, d, d)) * 0.1).astype(np.float32)),
            "bias": torch.zeros(d)}
    mask = torch.from_numpy((rng.random((2, 8, d)) < 0.5).astype(np.float32) * 2)
    got = fused_residual_block(x, p, groups=8, dropout_mask=mask)
    h = reference_gn_relu_cconv(x, p["gn1"]["scale"], p["gn1"]["bias"],
                                p["conv1"]["kernel"], p["conv1"]["bias"], groups=8,
                                precise=False)
    want = reference_gn_relu_cconv(h * mask, p["gn2"]["scale"], p["gn2"]["bias"],
                                   p["conv2"]["kernel"], p["conv2"]["bias"],
                                   residual=x, groups=8, precise=False)
    assert torch.equal(got, want)
