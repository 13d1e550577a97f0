"""The backward kernels' hopper routes (B2, B4) on the CPU: the split
products in the port (`dot3`, h36x/ops/pallas_temporal.py::_dot32(
precise=True)'s three bf16 passes; `dot_split` with three parts, the
hopper routes' six passes), the hopper routes' plain versions against h36x's
Pallas backward kernels in interpret mode (B2 through `_pallas_backward`
at precise=True, B4 through `_fused_backward`) and against the port's
float32 autograd, and which route each shape takes. Same numpy-seeded
inputs through both packages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h36x.ops.pallas_regressor import _fused_backward as jax_reg_bwd
from h36x.ops.pallas_temporal import _dot32
from h36x.ops.pallas_temporal import _pallas_backward as jax_temporal_bwd
from h36x_torch.ops.regressor import (
    _reference_forward,
    reference_joint_regressor_bwd_split,
    regressor_bwd_route,
)
from h36x_torch.ops.temporal import (
    bf16_parts,
    dot3,
    dot_split,
    gn_stats,
    reference_gn_relu_cconv,
    reference_gn_relu_cconv_bwd_split,
    temporal_bwd_route,
)

GRAD_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_pallas.py's gradient tolerance
# dot3 against _dot32(precise=True): on the CPU h36x keeps each lo part in
# float32, the port rounds it to bf16 as the card stores it, about 2^-17
# of each product; held relative to the sum of the products' magnitudes
DOT3_RTOL = 1e-4
# the hopper routes' plain versions against float32 autograd of the port's
# plain forward, by relative norm: two float32 summation orders
F32_REL_NORM = 1e-5
# dot_split with three parts against the float64 product, relative to the sum of the products'
# magnitudes: float32's own rounding over the contraction (2^-24 per sum)
SPLIT3_RTOL = 1e-6


def _rel_norm(got, want):
    return float((got - want).double().norm() / want.double().norm())


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("m, k, n, scale", [(40, 64, 24, 1.0), (7, 130, 5, 3.0),
                                            (1, 1024, 64, 0.1), (33, 17, 96, 1e3)])
def test_dot3_matches_h36x_precise_dot(rng, m, k, n, scale):
    a = (scale * rng.normal(size=(m, k))).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    got = dot3(*_t(a, b)).numpy()
    want = np.asarray(_dot32(jnp.asarray(a), jnp.asarray(b), True))
    mag = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    assert np.all(np.abs(got - want) <= DOT3_RTOL * mag)


@pytest.mark.parametrize("m, k, n, scale", [(40, 64, 24, 1.0), (7, 3072, 5, 3.0),
                                            (33, 17, 96, 1e3)])
def test_three_part_split_is_float32_accurate(rng, m, k, n, scale):
    a = (scale * rng.normal(size=(m, k))).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    mag = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    err6 = np.abs(dot_split(*_t(a, b), 3).numpy() - exact) / mag
    err3 = np.abs(dot3(*_t(a, b)).numpy() - exact) / mag
    assert err6.max() <= SPLIT3_RTOL
    # the three passes of two parts lose what a product of bf16 parts drops
    assert err3.max() > 4 * err6.max()


def test_bf16_parts_keep_float32(rng):
    v = torch.from_numpy(rng.normal(size=1000).astype(np.float32) * 10)
    p0, p1, p2 = bf16_parts(v, 3)
    assert torch.equal(p0, v.to(torch.bfloat16).float())
    assert float(((p0 + p1 + p2 - v).abs() / v.abs()).max()) <= 2.0 ** -24


def test_two_parts_are_the_cards_pair(rng):
    v = torch.from_numpy(rng.normal(size=1000).astype(np.float32) * 10)
    hi, lo = bf16_parts(v, 2)
    assert torch.equal(hi, v.to(torch.bfloat16).float())
    assert torch.equal(lo, (v - hi).to(torch.bfloat16).float())
    # hi + lo keeps about 16 significant bits
    assert float(((hi + lo - v).abs() / v.abs()).max()) < 2.0 ** -15


# -- B2: the temporal backward ------------------------------------------------

def _temporal_inputs(rng, b, t, d=32, o=64, k=3):
    return (rng.normal(size=(b, t, d)).astype(np.float32) * 1.5 + 0.3,
            (1 + 0.1 * rng.normal(size=d)).astype(np.float32),
            (0.1 * rng.normal(size=d)).astype(np.float32),
            (rng.normal(size=(k, d, o)) / np.sqrt(k * d)).astype(np.float32),
            rng.normal(size=(b, t, o)).astype(np.float32))


@functools.partial(jax.jit, static_argnames=("groups",))
def _jax_temporal_bwd(x, scale, bias, w, g, *, groups):
    return jax_temporal_bwd(x, scale, bias, w, g, groups, 1e-5, x.shape[2], True, True)


# T = K = 3: the edge sum reaches every row (h36x's Pallas backward takes T >= K);
# parts 2 is h36x's own precise arithmetic, 3 the hopper route's
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("b, t", [(2, 8), (3, 3), (5, 9), (2, 4)])
def test_temporal_bwd_split_matches_h36x_pallas_backward(rng, b, t, parts):
    x, scale, bias, w, g = _temporal_inputs(rng, b, t)
    got = reference_gn_relu_cconv_bwd_split(*_t(x, scale, bias, w, g), groups=8, parts=parts)
    want = _jax_temporal_bwd(*[jnp.asarray(v) for v in (x, scale, bias, w, g)], groups=8)
    for name, a, ref in zip(("dx", "dW", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **GRAD_TOL, err_msg=name)


# every T against float32 autograd, T < K included (each tap clamps to row
# 0), with and without the residual (whose gradient is g, outside the kernel)
@pytest.mark.parametrize("b, t, with_residual", [
    (2, 1, True), (2, 2, False), (3, 3, True), (2, 8, False), (4, 5, True)])
def test_temporal_bwd_split_matches_float32_autograd(rng, b, t, with_residual):
    x, scale, bias, w, g = _temporal_inputs(rng, b, t)
    cb = np.zeros(w.shape[2], np.float32)
    leaves = [v.requires_grad_() for v in _t(x, scale, bias, w)]
    res = torch.from_numpy(rng.normal(size=g.shape).astype(np.float32)) if with_residual else None
    out = reference_gn_relu_cconv(*leaves, torch.from_numpy(cb), res, groups=8)
    dx, dscale, dbias, dw = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    got = reference_gn_relu_cconv_bwd_split(*_t(x, scale, bias, w, g), groups=8)
    for name, a, ref in zip(("dx", "dW", "dscale", "dbias"), got, (dx, dw, dscale, dbias)):
        torch.testing.assert_close(a, ref, **GRAD_TOL, msg=name)
        assert _rel_norm(a, ref) <= F32_REL_NORM, name


def test_temporal_bwd_split_samples_do_not_bleed(rng):
    """B >= 2 with T <= K: zeroing one sample's output gradient zeroes its dW
    share and leaves the other sample's dx untouched."""
    x, scale, bias, w, g = _temporal_inputs(rng, 2, 2)
    full = reference_gn_relu_cconv_bwd_split(*_t(x, scale, bias, w, g), groups=8)
    g1 = g.copy()
    g1[0] = 0
    part = reference_gn_relu_cconv_bwd_split(*_t(x, scale, bias, w, g1), groups=8)
    assert torch.equal(part[0][0], torch.zeros_like(part[0][0]))
    torch.testing.assert_close(part[0][1], full[0][1], rtol=0, atol=0)
    alone = reference_gn_relu_cconv_bwd_split(*_t(x[1:], scale, bias, w, g[1:]), groups=8)
    torch.testing.assert_close(part[1], alone[1], rtol=1e-6, atol=1e-6)


def test_temporal_bwd_split_takes_the_forwards_statistics(rng):
    x, scale, bias, w, g = _temporal_inputs(rng, 2, 6)
    tx = _t(x, scale, bias, w, g)
    mean, rstd = gn_stats(tx[0], 8)
    a = reference_gn_relu_cconv_bwd_split(*tx, groups=8)
    b = reference_gn_relu_cconv_bwd_split(*tx, groups=8, mean=mean, rstd=rstd)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("d, o, route", [
    (1024, 1024, "hopper"), (64, 64, "hopper"), (128, 192, "hopper"),
    (96, 80, "general"), (32, 40, "general"), (64, 48, "general"), (32, 130, "general")])
def test_temporal_bwd_route(d, o, route):
    assert temporal_bwd_route(d, o) == route


# -- B4: the regressor backward -----------------------------------------------

def _regressor_inputs(rng, n, d=64, h=32, p=51):
    return (rng.normal(size=(n, d)).astype(np.float32),
            (rng.normal(size=(d + p, h)) / np.sqrt(d + p)).astype(np.float32),
            (0.1 * rng.normal(size=h)).astype(np.float32),
            (rng.normal(size=(h, h)) / np.sqrt(h)).astype(np.float32),
            (0.1 * rng.normal(size=h)).astype(np.float32),
            (rng.normal(size=(h, p)) / np.sqrt(h)).astype(np.float32),
            (0.1 * rng.normal(size=p)).astype(np.float32))


@functools.partial(jax.jit, static_argnames=("iters",))
def _jax_regressor_bwd(phi, w1, b1, w2, b2, w3, b3, g, *, iters):
    return jax_reg_bwd(phi, w1, b1, w2, b2, w3, b3, g, iters, 51, 8, True)


NAMES = ("dphi", "dw1", "db1", "dw2", "db2", "dw3", "db3")


@pytest.mark.parametrize("n, iters", [(40, 3), (13, 3), (1, 2), (9, 1)])
def test_regressor_bwd_split_matches_h36x_fused_backward(rng, n, iters):
    ins = _regressor_inputs(rng, n)
    g = rng.normal(size=(n, 51)).astype(np.float32)
    got = reference_joint_regressor_bwd_split(*_t(*ins, g), iters=iters)
    want = _jax_regressor_bwd(*[jnp.asarray(v) for v in (*ins, g)], iters=iters)
    for name, a, ref in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("n, iters", [(40, 3), (7, 4)])
def test_regressor_bwd_split_matches_float32_autograd(rng, n, iters):
    ins = _regressor_inputs(rng, n)
    g = rng.normal(size=(n, 51)).astype(np.float32)
    leaves = [v.requires_grad_() for v in _t(*ins)]
    out = _reference_forward(*leaves, iters, 51)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    got = reference_joint_regressor_bwd_split(*_t(*ins, g), iters=iters)
    for name, a, ref in zip(NAMES, got, want):
        assert a.shape == ref.shape, name
        torch.testing.assert_close(a, ref, **GRAD_TOL, msg=name)
        assert _rel_norm(a, ref) <= F32_REL_NORM, name


def test_two_parts_miss_the_float32_tolerance_three_do_not():
    """Why the hopper routes split into three parts: at the shape and the
    tie-free weights of the card test of the regressor backward (N 100, D
    128, H 256, P 64, 4 rounds), h36x's 3-pass split puts gradient elements
    outside rtol 1e-4 / atol 1e-4 of float32 autograd (its ~2^-18 of each
    product, on gradients of magnitude ~100), the six passes none."""
    g = torch.Generator().manual_seed(1)
    n, d, h, p, iters = 100, 128, 256, 64, 4

    def away(k):
        mag = 0.6 + 0.9 * torch.rand(k, generator=g)
        return torch.where(torch.rand(k, generator=g) < 0.5, -mag, mag)

    ws = [0.1 * torch.randn(d + p, h, generator=g) / (d + p) ** 0.5, away(h),
          0.1 * torch.randn(h, h, generator=g) / h ** 0.5, away(h),
          torch.randn(h, p, generator=g) / h ** 0.5, 0.1 * torch.randn(p, generator=g)]
    phi = torch.randn(n, d, generator=torch.Generator().manual_seed(4))
    gout = torch.randn(n, p, generator=torch.Generator().manual_seed(3))
    leaves = [v.clone().requires_grad_() for v in (phi, *ws)]
    want = torch.autograd.grad(_reference_forward(*leaves, iters, p), leaves, gout)
    outside = {}
    for parts in (2, 3):
        got = reference_joint_regressor_bwd_split(phi, *ws, gout, iters, parts=parts)
        outside[parts] = sum(int((~torch.isclose(a, w, rtol=1e-4, atol=1e-4)).sum())
                             for a, w in zip(got, want))
        assert max(_rel_norm(a, w) for a, w in zip(got, want)) <= F32_REL_NORM
    assert outside[2] > 0 and outside[3] == 0, outside


@pytest.mark.parametrize("d, h, p, route", [
    (1024, 1024, 51, "hopper"), (64, 64, 64, "hopper"), (128, 256, 30, "hopper"),
    (96, 200, 51, "general"), (1000, 64, 30, "general"), (64, 96, 51, "general"),
    (64, 64, 65, "general"), (1, 1, 1, "general")])
def test_regressor_bwd_route(d, h, p, route):
    assert regressor_bwd_route(d, h, p) == route
