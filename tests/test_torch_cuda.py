"""h36x_torch CUDA kernels against their plain versions on the card, at
small odd shapes that the main paths do not reach (ragged tiles, group
sizes, tap counts, widths that are no multiple of a tile), plus what the
wrappers refuse. The backward kernels are held against autograd of the
plain versions. B1 and B3 on both routes of `precise` (the fast routes
also at the serving and streaming shapes), and the frozen streaming push
through its CUDA graph against the same step run eagerly. Marked `cuda`: they skip without a GPU. On a machine with
one, and without jax, run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from h36x_torch.ops.bottleneck import (
    ROUTES,
    bottleneck_route,
    fused_bottleneck,
    launch_on_route,
    prepare_bottleneck,
    reference_bottleneck,
)
from h36x_torch.ops.matmul_probe import (
    TILES,
    make_probe_matmul,
    probe_matmul,
    reference_matmul,
)
from h36x_torch.ops import regressor as reg_ops
from h36x_torch.ops import temporal as temporal_ops
from h36x_torch.ops.regressor import (
    _reference_forward,
    fused_joint_regressor,
    joint_regressor_bwd,
    reference_joint_regressor_bwd_split,
)
from h36x_torch.ops.regressor import bf16_weights as regressor_bf16
from h36x_torch.ops.temporal import (
    bf16_kernel,
    fused_gn_relu_cconv,
    gn_relu_cconv_bwd,
    gn_stats,
    reference_gn_relu_cconv,
    reference_gn_relu_cconv_bwd_split,
)

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-4)  # FP32 on both sides; sums reordered
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)  # the gradient tolerance of test_pallas.py


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _temporal(dev, b, t, d, o, k, groups, residual, seed=0):
    g = torch.Generator().manual_seed(seed)
    args = [torch.randn(b, t, d, generator=g) * 1.5 + 0.3,
            1 + 0.1 * torch.randn(d, generator=g), 0.1 * torch.randn(d, generator=g),
            torch.randn(k, d, o, generator=g) / (k * d) ** 0.5,
            0.1 * torch.randn(o, generator=g),
            torch.randn(b, t, o, generator=g) if residual else None]
    return [None if a is None else a.to(dev) for a in args]


@pytest.mark.parametrize("b, t, d, o, k, groups, residual", [
    (3, 7, 96, 80, 3, 8, False),
    (3, 7, 96, 80, 3, 8, True),
    (2, 1, 64, 64, 3, 8, True),
    (2, 2, 64, 48, 3, 4, False),
    (5, 9, 32, 130, 1, 2, False),
    (2, 33, 64, 64, 2, 16, True),
    (1, 70, 128, 64, 5, 32, False),
])
def test_temporal_kernel_matches_plain(dev, b, t, d, o, k, groups, residual):
    args = _temporal(dev, b, t, d, o, k, groups, residual)
    before = fused_gn_relu_cconv.launches
    got = fused_gn_relu_cconv(*args, groups=groups, precise=True)
    torch.cuda.synchronize()
    assert fused_gn_relu_cconv.launches == before + 1
    want = reference_gn_relu_cconv(*args, groups=groups)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("b, t_buf, d, o, groups, residual", [
    (3, 12, 96, 80, 8, True),
    (3, 12, 96, 80, 8, False),
    (8, 65, 128, 128, 32, True),   # the rollout's buffer: T 40 + 25 steps
    (1, 9, 64, 64, 8, True),       # one sample: any batch stride is dense
])
def test_temporal_kernel_takes_a_prefix_of_a_longer_buffer(dev, b, t_buf, d, o, groups,
                                                           residual):
    """x and residual as `buf[:, :t]` (batch stride t_buf * D, what the
    rollout hands over) for every t from 1 to t_buf: bit for bit what the
    kernel gives on a dense copy, and the plain version within TOL."""
    x_buf, scale, bias, w, cb, r_buf = _temporal(dev, b, t_buf, d, o, 3, groups, residual)
    for t in range(1, t_buf + 1):
        x, res = x_buf[:, :t], None if r_buf is None else r_buf[:, :t]
        assert b == 1 or t == t_buf or not x.is_contiguous()
        got = fused_gn_relu_cconv(x, scale, bias, w, cb, res, groups=groups, precise=True)
        dense = fused_gn_relu_cconv(x.contiguous(), scale, bias, w, cb,
                                    None if res is None else res.contiguous(),
                                    groups=groups, precise=True)
        assert got.is_contiguous() and torch.equal(got, dense), t
        want = reference_gn_relu_cconv(x, scale, bias, w, cb, res, groups=groups)
        torch.testing.assert_close(got, want, **TOL, msg=f"t={t}")


def test_temporal_backward_needs_dense_inputs(dev):
    x_buf, scale, bias, w, cb, _ = _temporal(dev, 2, 6, 64, 64, 3, 8, False)
    out = fused_gn_relu_cconv(x_buf[:, :4], scale.requires_grad_(), bias, w, cb, groups=8,
                              precise=True)
    with pytest.raises(ValueError, match="contiguous"):
        out.sum().backward()


@pytest.mark.parametrize("n, d, h, p, iters", [
    (37, 96, 200, 51, 3),
    (5, 1000, 64, 30, 2),
    (16, 64, 2300, 51, 1),
    (100, 128, 256, 64, 4),
    (1, 1024, 1024, 51, 3),   # one streamed frame at the flagship width
    (1, 64, 96, 51, 3),
])
def test_regressor_kernel_matches_plain(dev, n, d, h, p, iters):
    g = torch.Generator().manual_seed(1)
    ws = [torch.randn(n, d, generator=g),
          torch.randn(d + p, h, generator=g) / (d + p) ** 0.5,
          0.1 * torch.randn(h, generator=g),
          torch.randn(h, h, generator=g) / h ** 0.5,
          0.1 * torch.randn(h, generator=g),
          torch.randn(h, p, generator=g) / h ** 0.5,
          0.1 * torch.randn(p, generator=g)]
    ws = [w.to(dev) for w in ws]
    before = fused_joint_regressor.launches
    got = fused_joint_regressor(*ws, iters, p, precise=True)
    torch.cuda.synchronize()
    assert fused_joint_regressor.launches == before + 1
    torch.testing.assert_close(got, _reference_forward(*ws, iters, p), **TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, scale, bias, w, cb, _ = _temporal(dev, 2, 4, 64, 64, 3, 8, False)
    with pytest.raises(TypeError, match="float32"):
        fused_gn_relu_cconv(x.double(), scale, bias, w, cb, groups=8, precise=True)
    with pytest.raises(ValueError, match="contiguous"):
        fused_gn_relu_cconv(x.transpose(0, 1).contiguous().transpose(0, 1),
                            scale, bias, w, cb, groups=8, precise=True)
    with pytest.raises(ValueError, match="expected cuda"):
        fused_gn_relu_cconv(x, scale.cpu(), bias, w, cb, groups=8, precise=True)
    # a tensor that requires grad is taken: its gradient is the backward kernel's
    before = gn_relu_cconv_bwd.launches
    fused_gn_relu_cconv(x, scale.requires_grad_(), bias, w, cb, groups=8,
                        precise=True).sum().backward()
    assert scale.grad is not None and gn_relu_cconv_bwd.launches == before + 1
    phi = torch.randn(4, 64, device=dev)

    def weights(h):
        return [torch.zeros(64 + 51, h, device=dev), torch.zeros(h, device=dev),
                torch.zeros(h, h, device=dev), torch.zeros(h, device=dev),
                torch.zeros(h, 51, device=dev), torch.zeros(51, device=dev)]

    before = fused_joint_regressor.launches
    # at H=2400 the block's activations outgrow its shared memory
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_joint_regressor(phi, *weights(2400), 3, 51, precise=True)
    assert fused_joint_regressor.launches == before
    # the refused launch leaves no error behind for the next one
    assert fused_joint_regressor(phi, *weights(64), 3, 51, precise=True).shape == (4, 51)


# -- the fast routes of B1 and B3 (precise=False) ---------------------------------
# Against the fast mode's plain version (the same operands rounded alike,
# f32 sums in another order): element-wise within FAST_TOL and by relative
# norm within FAST_REL_NORM; against the float32 plain version by relative
# norm within 2^-8 (bf16 weights: about 2^-9 relative each).
FAST_TOL = dict(rtol=1e-3, atol=1e-4)
FAST_REL_NORM = 1e-4
F32_REL_NORM = 2.0 ** -8


def _rel_norm(got, want):
    return float((got - want).double().norm() / want.double().norm())


@pytest.mark.parametrize("b, t, d, o, k, groups, residual", [
    (3, 7, 128, 128, 3, 8, True),
    (2, 1, 64, 64, 3, 8, True),
    (1, 70, 128, 64, 5, 32, False),
    (5, 9, 64, 192, 1, 2, False),
    (2, 33, 64, 64, 2, 16, True),
    (16, 40, 1024, 1024, 3, 32, False),  # the serving shape
    (1, 40, 1024, 1024, 3, 32, True),    # one exact push
])
def test_temporal_fast_route_matches_its_plain_version(dev, b, t, d, o, k, groups,
                                                       residual):
    args = _temporal(dev, b, t, d, o, k, groups, residual)
    before = fused_gn_relu_cconv.launches
    got = fused_gn_relu_cconv(*args, groups=groups)  # precise=False, the default
    again = fused_gn_relu_cconv(*args, groups=groups, kernel_bf16=bf16_kernel(args[3]))
    torch.cuda.synchronize()
    assert fused_gn_relu_cconv.launches == before + 2
    assert torch.equal(got, again)  # run to run, bit for bit
    want = reference_gn_relu_cconv(*args, groups=groups, precise=False)
    torch.testing.assert_close(got, want, **FAST_TOL)
    assert _rel_norm(got, want) <= FAST_REL_NORM
    f32 = reference_gn_relu_cconv(*args, groups=groups)
    assert _rel_norm(got, f32) <= F32_REL_NORM


@pytest.mark.parametrize("b, t_buf, groups, residual", [
    (3, 12, 8, True),
    (8, 65, 32, True),   # the rollout's buffer: T 40 + 25 steps
])
def test_temporal_fast_route_takes_a_prefix_of_a_longer_buffer(dev, b, t_buf, groups,
                                                               residual):
    x_buf, scale, bias, w, cb, r_buf = _temporal(dev, b, t_buf, 128, 128, 3, groups,
                                                 residual)
    wb = bf16_kernel(w)
    for t in range(1, t_buf + 1):
        x, res = x_buf[:, :t], None if r_buf is None else r_buf[:, :t]
        got = fused_gn_relu_cconv(x, scale, bias, w, cb, res, groups=groups,
                                  kernel_bf16=wb)
        dense = fused_gn_relu_cconv(x.contiguous(), scale, bias, w, cb,
                                    None if res is None else res.contiguous(),
                                    groups=groups, kernel_bf16=wb)
        assert torch.equal(got, dense), t
        want = reference_gn_relu_cconv(x, scale, bias, w, cb, res, groups=groups,
                                       precise=False)
        torch.testing.assert_close(got, want, **FAST_TOL, msg=f"t={t}")


@pytest.mark.parametrize("n, d, h, p, iters", [
    (37, 128, 256, 51, 3),
    (13, 64, 64, 30, 2),
    (100, 128, 192, 64, 4),
    (1, 1024, 1024, 51, 3),     # one streamed frame at the flagship width
    (200, 1024, 1024, 51, 3),   # a rollout's future strips
    (640, 1024, 1024, 51, 3),   # the serving shape
])
def test_regressor_fast_route_matches_its_plain_version(dev, n, d, h, p, iters):
    g = torch.Generator().manual_seed(1)
    ws = [torch.randn(n, d, generator=g),
          torch.randn(d + p, h, generator=g) / (d + p) ** 0.5,
          0.1 * torch.randn(h, generator=g),
          torch.randn(h, h, generator=g) / h ** 0.5,
          0.1 * torch.randn(h, generator=g),
          torch.randn(h, p, generator=g) / h ** 0.5,
          0.1 * torch.randn(p, generator=g)]
    ws = [w.to(dev) for w in ws]
    before = fused_joint_regressor.launches
    got = fused_joint_regressor(*ws, iters, p)  # precise=False, the default
    again = fused_joint_regressor(*ws, iters, p,
                                  weights_bf16=regressor_bf16(ws[1], ws[3], ws[5]))
    torch.cuda.synchronize()
    assert fused_joint_regressor.launches == before + 2
    assert torch.equal(got, again)
    want = _reference_forward(*ws, iters, p, precise=False)
    torch.testing.assert_close(got, want, **FAST_TOL)
    assert _rel_norm(got, want) <= FAST_REL_NORM
    assert _rel_norm(got, _reference_forward(*ws, iters, p)) <= F32_REL_NORM


def test_fast_routes_refuse_what_they_do_not_take(dev):
    x, scale, bias, w, cb, _ = _temporal(dev, 2, 4, 96, 80, 3, 8, False)
    before = fused_gn_relu_cconv.launches
    with pytest.raises(ValueError, match="multiples of 64"):
        fused_gn_relu_cconv(x, scale, bias, w, cb, groups=8)
    x, scale, bias, w, cb, _ = _temporal(dev, 2, 4, 64, 64, 3, 8, False)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_gn_relu_cconv(x, scale, bias, w, cb, groups=8, kernel_bf16=w)
    assert fused_gn_relu_cconv.launches == before
    ws = [torch.zeros(4, 96, device=dev), torch.zeros(96 + 51, 64, device=dev),
          torch.zeros(64, device=dev), torch.zeros(64, 64, device=dev),
          torch.zeros(64, device=dev), torch.zeros(64, 51, device=dev),
          torch.zeros(51, device=dev)]
    with pytest.raises(ValueError, match="multiples of 64"):
        fused_joint_regressor(*ws, 3, 51)


@pytest.mark.parametrize("precise", [True, False])
def test_frozen_push_graph_replays_the_eager_step(dev, precise):
    """The frozen push through its CUDA graph against the same step run
    eagerly on a second predictor in the same state, push by push through
    freeze -> push -> re-freeze -> push. The first push after a freeze runs
    eagerly (one regressor launch counted, none at the capture); every later
    one is a replay, which no wrapper counts and `replays` does."""
    from h36x_torch.models.phd import PHDFor3DJoints, param_tree
    from h36x_torch.serve import StreamingPredictor

    model = PHDFor3DJoints(latent_dim=128, feature_dim=64, number_blocks=2, groups=8,
                           regressor_hidden=128, device=dev)
    kw = dict(window=8, feature_dim=64, groups=8, precise=precise, device=dev)
    graph, eager = (StreamingPredictor(param_tree(model), **kw) for _ in range(2))
    feats = torch.randn(30, 64, generator=torch.Generator().manual_seed(6)).numpy()
    for i, f in enumerate(feats):
        if i in (8, 20):
            graph.freeze()
            eager.freeze()
        if not graph.frozen:
            np.testing.assert_array_equal(graph.push(f), eager.push(f))
            continue
        counts = (fused_gn_relu_cconv.launches, fused_joint_regressor.launches)
        replays, first = graph.replays, graph._graph is None
        got = graph.push(f)
        assert (fused_gn_relu_cconv.launches - counts[0],
                fused_joint_regressor.launches - counts[1]) == (0, int(first))
        assert graph.replays == replays + (not first)
        eager._seen += 1
        with torch.inference_mode():  # the predictor's buffers are inference tensors
            eager._io["feat"].copy_(torch.from_numpy(f))
            eager._frozen_step()
        np.testing.assert_allclose(got, eager._io["joints"].cpu().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=f"push {i}")
    assert graph._graph is not None and eager._graph is None
    assert graph.replays == 30 - 8 - 2 and eager.replays == 0
    graph.unfreeze()
    assert graph._graph is None


def test_fast_regressor_chains_on_two_streams_at_once(dev):
    """Two fast B3 calls in flight together on two streams (the daemon's
    device thread beside a streaming predictor): each chain's grid barrier
    needs all its blocks resident, which its cooperative launch guarantees,
    so both finish and each equals the same call made alone."""
    g = torch.Generator().manual_seed(9)
    d = h = 1024
    p, iters = 51, 3
    ws = tuple(t.to(dev) for t in (
        torch.randn(d + p, h, generator=g) / 32, torch.randn(h, generator=g) / 32,
        torch.randn(h, h, generator=g) / 32, torch.randn(h, generator=g) / 32,
        torch.randn(h, p, generator=g) / 32, torch.randn(p, generator=g) / 32))
    wb = regressor_bf16(ws[0], ws[2], ws[4])
    # 1280 rows: each chain is one block per SM, so neither fits beside the
    # other
    phis = [torch.randn(1280, d, generator=g).to(dev) for _ in range(2)]
    alone = [fused_joint_regressor(phi, *ws, iters, p, weights_bf16=wb) for phi in phis]
    streams = [torch.cuda.Stream(dev) for _ in phis]
    torch.cuda.synchronize()
    outs = [None, None]
    for _ in range(20):
        for i, (s, phi) in enumerate(zip(streams, phis)):
            with torch.cuda.stream(s):
                outs[i] = fused_joint_regressor(phi, *ws, iters, p, weights_bf16=wb)
    torch.cuda.synchronize()
    for got, want in zip(outs, alone):
        assert torch.equal(got, want)


def _grads(fn, leaves, gout, **kw):
    out = fn(*leaves, **kw)
    return torch.autograd.grad(out, [v for v in leaves if v is not None], gout)


@pytest.mark.parametrize("b, t, d, o, k, groups, residual", [
    (3, 7, 96, 80, 3, 8, True),
    (2, 5, 64, 64, 3, 1, False),
    (1, 1, 64, 48, 3, 8, True),
    (1, 2, 32, 40, 3, 4, False),
    (5, 9, 32, 130, 1, 2, False),
    (2, 33, 64, 64, 2, 16, True),
    (1, 70, 128, 64, 5, 32, False),
])
def test_temporal_backward_kernel_matches_autograd(dev, b, t, d, o, k, groups,
                                                  residual):
    args = _temporal(dev, b, t, d, o, k, groups, residual)
    leaves = [None if a is None else a.clone().requires_grad_() for a in args]
    gout = torch.randn(b, t, o, generator=torch.Generator().manual_seed(2)).to(dev)
    before = gn_relu_cconv_bwd.launches
    got = _grads(fused_gn_relu_cconv, leaves, gout, groups=groups, precise=True)
    torch.cuda.synchronize()
    assert gn_relu_cconv_bwd.launches == before + 1
    want = _grads(reference_gn_relu_cconv, leaves, gout, groups=groups)
    for name, a, w in zip(("dx", "dscale", "dbias", "dW", "dcb", "dres"), got, want):
        torch.testing.assert_close(a, w, **GRAD_TOL, msg=name)


def _regressor_weights(dev, d, h, p, seed=1):
    """Hidden biases 0.6-1.5 away from 0 and small weights: no ReLU input
    lies near 0, where two summation orders could pick different masks."""
    g = torch.Generator().manual_seed(seed)

    def away(n):
        mag = 0.6 + 0.9 * torch.rand(n, generator=g)
        return torch.where(torch.rand(n, generator=g) < 0.5, -mag, mag)

    ws = [0.1 * torch.randn(d + p, h, generator=g) / (d + p) ** 0.5, away(h),
          0.1 * torch.randn(h, h, generator=g) / h ** 0.5, away(h),
          torch.randn(h, p, generator=g) / h ** 0.5, 0.1 * torch.randn(p, generator=g)]
    return [w.to(dev) for w in ws]


def _init_weights(dev, d, h, p, seed=5):
    """Weights and biases at their init scale, U(+-1/sqrt(fan_in))."""
    g = torch.Generator().manual_seed(seed)

    def init(shape, fan_in):
        return (torch.rand(shape, generator=g) * 2 - 1) / fan_in ** 0.5

    ws = [init((d + p, h), d + p), init(h, d + p), init((h, h), h), init(h, h),
          init((h, p), h), init(p, h)]
    return [w.to(dev) for w in ws]


def _untied_rows(dev, n, d, ws, iters, p, margin=1e-5, seed=4):
    """(n, d) normal rows none of whose ReLU inputs in the regressor loop
    lies within `margin` of 0 in float64 (a row with a near-tie is drawn
    again), so that FP32 kernel and FP32 autograd take the same masks."""
    g = torch.Generator().manual_seed(seed)
    w1, b1, w2, b2, w3, b3 = (w.double() for w in ws)
    phi = torch.randn(n, d, generator=g).double().to(dev)
    for _ in range(50):
        y, tied = phi.new_zeros(n, p), torch.zeros(n, dtype=torch.bool, device=dev)
        for _ in range(iters):
            a1 = torch.cat([phi, y], -1) @ w1 + b1
            a2 = torch.relu(a1) @ w2 + b2
            y = y + torch.relu(a2) @ w3 + b3
            tied |= (a1.abs() < margin).any(1) | (a2.abs() < margin).any(1)
        if not tied.any():
            return phi.float()
        phi[tied] = torch.randn(int(tied.sum()), d, generator=g).double().to(dev)
    raise AssertionError("could not draw rows clear of ReLU ties")


@pytest.mark.parametrize("weights", ["tie-free", "init-scale"])
@pytest.mark.parametrize("n, d, h, p, iters", [
    (37, 96, 200, 51, 3),
    (5, 1000, 64, 30, 2),
    (100, 128, 256, 64, 4),
    (33, 64, 96, 51, 1),
])
def test_regressor_backward_kernel_matches_autograd(dev, weights, n, d, h, p, iters):
    """Every gradient element-wise and by relative norm. At init scale the
    ReLU masks differ from row to row and round to round, so a mask taken
    from the wrong row or round shows; tie-free weights fix each unit's mask
    for every row."""
    ws = (_regressor_weights if weights == "tie-free" else _init_weights)(dev, d, h, p)
    phi = _untied_rows(dev, n, d, ws, iters, p)
    if weights == "init-scale":
        masks = (torch.cat([phi, torch.zeros(n, p, device=dev)], -1) @ ws[0] + ws[1]) > 0
        assert masks.any(0).float().mean() > 0.9 and (~masks).any(0).float().mean() > 0.9
    gout = torch.randn(n, p, generator=torch.Generator().manual_seed(3)).to(dev)
    leaves = [v.clone().requires_grad_() for v in (phi, *ws)]
    before = joint_regressor_bwd.launches
    got = _grads(fused_joint_regressor, leaves, gout, iters=iters, out_dim=p,
                 precise=True)
    torch.cuda.synchronize()
    assert joint_regressor_bwd.launches == before + 1
    want = _grads(_reference_forward, leaves, gout, iters=iters, out_dim=p)
    for name, a, w in zip(("dphi", "dw1", "db1", "dw2", "db2", "dw3", "db3"), got, want):
        torch.testing.assert_close(a, w, **TOL, msg=name)
        assert float((a - w).norm() / w.norm()) <= 1e-4, name


def test_refused_regressor_backward_raises_and_leaves_no_error(dev):
    # more than 65535 row tiles of 32: the grid of the backward's GEMMs
    # refuses the launch (widths of 1 keep the tensors small)
    n = 65536 * 32
    phi = torch.randn(n, 1, device=dev)
    ws = _regressor_weights(dev, 1, 1, 1)
    before = joint_regressor_bwd.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        joint_regressor_bwd(phi, *ws, torch.ones(n, 1, device=dev), 3)
    assert joint_regressor_bwd.launches == before
    # the refused launch leaves no error behind for the next one
    phi = torch.randn(40, 16, device=dev)
    grads = joint_regressor_bwd(phi, *_regressor_weights(dev, 16, 8, 51),
                                torch.ones(40, 51, device=dev), 3)
    torch.cuda.synchronize()
    assert grads[0].shape == (40, 16) and all(bool(torch.isfinite(t).all()) for t in grads)


def test_backward_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, scale, bias, w, cb, _ = _temporal(dev, 2, 4, 64, 64, 3, 8, False)
    mean = torch.zeros(2, 8, device=dev)
    with pytest.raises(ValueError, match="do not fit"):
        gn_relu_cconv_bwd(x, scale, bias, w, torch.ones(2, 4, 32, device=dev),
                          mean, mean, 8)
    with pytest.raises(TypeError, match="float32"):
        gn_relu_cconv_bwd(x, scale, bias, w, torch.ones(2, 4, 64, device=dev).double(),
                          mean, mean, 8)
    with pytest.raises(ValueError, match="iters"):
        joint_regressor_bwd(torch.ones(4, 16, device=dev),
                            *_regressor_weights(dev, 16, 8, 51),
                            torch.ones(4, 51, device=dev), 0)


# -- the backward kernels' two routes -------------------------------------------

REL_NORM = 1e-4  # each gradient by relative norm (chip_smoke.py's REL_NORM_TOL)


def _hold(got, want, tol, names):
    for name, a, w in zip(names, got, want):
        torch.testing.assert_close(a, w, **tol, msg=name)
        assert _rel_norm(a, w) <= REL_NORM, name


@pytest.mark.parametrize("route", temporal_ops.BWD_ROUTES)
@pytest.mark.parametrize("b, t, d, o, k, groups", [
    (3, 7, 64, 128, 3, 8), (2, 2, 128, 64, 3, 16), (1, 1, 64, 64, 3, 8),
    (5, 40, 64, 192, 2, 4), (2, 70, 128, 64, 5, 32)])
def test_temporal_backward_routes_match_autograd_and_their_plain_version(
        dev, route, b, t, d, o, k, groups):
    """Both routes at widths the hopper route takes: against autograd of the
    float32 plain forward (dx, dW, dscale, dbias), two runs bit for bit, and
    the hopper route against its split plain version. B*T of 7 to 140 rows:
    the hopper route's dW reads the rows past B*T as zeros."""
    x, scale, bias, w, cb, _ = _temporal(dev, b, t, d, o, k, groups, False)
    gout = torch.randn(b, t, o, generator=torch.Generator().manual_seed(2)).to(dev)
    mean, rstd = gn_stats(x, groups)
    got = temporal_ops.bwd_on_route(x, scale, bias, w, gout, mean, rstd, groups, route)
    again = temporal_ops.bwd_on_route(x, scale, bias, w, gout, mean, rstd, groups, route)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    leaves = [v.clone().requires_grad_() for v in (x, scale, bias, w)]
    dx, dscale, dbias, dw = torch.autograd.grad(
        reference_gn_relu_cconv(*leaves, cb, groups=groups), leaves, gout)
    names = ("dx", "dW", "dscale", "dbias")
    _hold(got, (dx, dw, dscale, dbias), GRAD_TOL, names)
    if route == "hopper":
        split = reference_gn_relu_cconv_bwd_split(x, scale, bias, w, gout, groups,
                                                  mean=mean, rstd=rstd)
        _hold(got, split, GRAD_TOL, names)


@pytest.mark.parametrize("route", reg_ops.BWD_ROUTES)
@pytest.mark.parametrize("n, d, h, p, iters", [
    (37, 64, 192, 51, 3), (100, 128, 256, 64, 4), (1, 64, 64, 51, 2), (130, 64, 128, 30, 1)])
def test_regressor_backward_routes_match_autograd_and_their_plain_version(
        dev, route, n, d, h, p, iters):
    """Both routes at widths the hopper route takes, init-scale weights on
    rows clear of ReLU ties: against autograd of the float32 plain forward,
    two runs bit for bit, and the hopper route against its split plain
    version."""
    ws = _init_weights(dev, d, h, p)
    phi = _untied_rows(dev, n, d, ws, iters, p)
    gout = torch.randn(n, p, generator=torch.Generator().manual_seed(3)).to(dev)
    got = reg_ops.bwd_on_route(phi, *ws, gout, iters, route)
    again = reg_ops.bwd_on_route(phi, *ws, gout, iters, route)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    leaves = [v.clone().requires_grad_() for v in (phi, *ws)]
    want = _grads(_reference_forward, leaves, gout, iters=iters, out_dim=p)
    names = ("dphi", "dw1", "db1", "dw2", "db2", "dw3", "db3")
    _hold(got, want, TOL, names)
    if route == "hopper":
        _hold(got, reference_joint_regressor_bwd_split(phi, *ws, gout, iters), TOL, names)


def test_backward_wrappers_take_the_route_of_the_widths(dev):
    """64-multiples on the hopper route, odd widths on the general one, each
    launch counted once and by its route."""
    for d, o, route in ((64, 128, "hopper"), (96, 80, "general")):
        args = _temporal(dev, 2, 5, d, o, 3, 8, False)
        leaves = [None if a is None else a.clone().requires_grad_() for a in args]
        before = dict(gn_relu_cconv_bwd.launches_by_route)
        _grads(fused_gn_relu_cconv, leaves, torch.ones(2, 5, o, device=dev), groups=8,
               precise=True)
        after = gn_relu_cconv_bwd.launches_by_route
        assert {r: after[r] - before[r] for r in after} == {
            r: int(r == route) for r in after}
    for d, h, route in ((64, 64, "hopper"), (1000, 64, "general")):
        ws = _regressor_weights(dev, d, h, 30)
        before = dict(joint_regressor_bwd.launches_by_route)
        joint_regressor_bwd(torch.randn(5, d, device=dev), *ws, torch.ones(5, 30, device=dev),
                            2)
        after = joint_regressor_bwd.launches_by_route
        assert {r: after[r] - before[r] for r in after} == {
            r: int(r == route) for r in after}


def test_hopper_backward_refuses_other_widths_and_leaves_no_error(dev):
    """The hopper route named for widths it does not take: the entry point
    refuses the launch, the wrapper raises, and the next launch runs."""
    x, scale, bias, w, _, _ = _temporal(dev, 2, 4, 96, 80, 3, 8, False)
    mean, rstd = gn_stats(x, 8)
    gout = torch.ones(2, 4, 80, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        temporal_ops.bwd_on_route(x, scale, bias, w, gout, mean, rstd, 8, "hopper")
    ws = _regressor_weights(dev, 1000, 64, 30)
    with pytest.raises(RuntimeError, match="CUDA error"):
        reg_ops.bwd_on_route(torch.ones(4, 1000, device=dev), *ws,
                             torch.ones(4, 30, device=dev), 2, "hopper")
    with pytest.raises(ValueError, match="route"):
        reg_ops.bwd_on_route(torch.ones(4, 1000, device=dev), *ws,
                             torch.ones(4, 30, device=dev), 2, "fast")
    got = temporal_ops.bwd_on_route(x, scale, bias, w, gout, mean, rstd, 8, "general")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got)


# -- B5, the fused bottleneck ---------------------------------------------------

# bfloat16 against its plain version: both sum the same bf16 products in f32
# in another order, so `a`, `b` and the output round to a neighbouring bf16
# value now and then; one bf16 ulp (2^-8 relative) bounds the relative norm
BF16_REL_NORM = 2.0 ** -8


def _folded(c_in, c_mid, c_out, seed=0):
    """Random folded weights (f32, h36x's layouts); a projection whenever
    C_in != C_out, as in ResNet-50."""
    g = torch.Generator().manual_seed(seed)

    def init(shape, fan_in):
        return torch.randn(shape, generator=g) / fan_in ** 0.5

    f = {"w1": init((c_in, c_mid), c_in), "b1": 0.1 * torch.randn(c_mid, generator=g),
         "w2": init((3, 3, c_mid, c_mid), 9 * c_mid),
         "b2": 0.1 * torch.randn(c_mid, generator=g),
         "w3": init((c_mid, c_out), c_mid), "b3": 0.1 * torch.randn(c_out, generator=g)}
    if c_in != c_out:
        f["wp"] = init((c_in, c_out), c_in)
        f["bp"] = 0.1 * torch.randn(c_out, generator=g)
    return f


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, h, w, c_in, c_mid, c_out", [
    (2, 56, 56, 64, 64, 256),      # layer1_0: projection
    (2, 56, 56, 256, 64, 256),     # layer1
    (2, 28, 28, 512, 128, 512),    # layer2
    (2, 14, 14, 1024, 256, 1024),  # layer3
    (2, 7, 7, 2048, 512, 2048),    # layer4
    (3, 9, 9, 64, 16, 64),         # odd size, 81 rows: a ragged row tile
    (2, 5, 3, 20, 12, 36),         # widths no multiple of 16 bytes: scalar loads
    (1, 1, 1, 32, 8, 32),          # a single pixel: every tap but the centre is padding
    (1, 1, 7, 16, 16, 16),
])
def test_bottleneck_kernel_matches_plain(dev, dtype, b, h, w, c_in, c_mid, c_out):
    folded = _folded(c_in, c_mid, c_out)
    g = torch.Generator().manual_seed(1)
    x = torch.relu(torch.randn(b, h * w, c_in, generator=g)).to(dev, dtype)
    before = fused_bottleneck.launches
    got = fused_bottleneck(x, folded, h, w)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h * w, c_out)
    want = reference_bottleneck(x, folded, h, w)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        assert rel <= BF16_REL_NORM, rel


def test_bottleneck_refused_launch_raises_and_leaves_no_error(dev):
    folded = _folded(64, 16, 64)
    x = torch.randn(0, 16, 64, device=dev)  # no rows: a grid of 0 blocks
    before = fused_bottleneck.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_bottleneck(x, folded, 4, 4)
    assert fused_bottleneck.launches == before
    x = torch.randn(2, 16, 64, device=dev)
    got = fused_bottleneck(x, folded, 4, 4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, reference_bottleneck(x, folded, 4, 4), **TOL)


# the 13 stride-1 blocks' shapes (side, C_in, C_mid, C_out), projection first
STAGE_SHAPES = [(56, 64, 64, 256), (56, 256, 64, 256), (28, 512, 128, 512),
                (14, 1024, 256, 1024), (7, 2048, 512, 2048)]


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("side, c_in, c_mid, c_out", STAGE_SHAPES)
def test_bottleneck_hopper_route_matches_plain(dev, n, side, c_in, c_mid, c_out):
    """The TMA + wgmma route at every stage shape, N 1 and 2: M = N*side^2
    is no multiple of the 128-row tile at 7x7 and 14x14 (ragged M filled
    with zeros by TMA and by the 3x3's copies), by relative norm in bf16."""
    folded = _folded(c_in, c_mid, c_out)
    g = torch.Generator().manual_seed(2)
    x = torch.relu(torch.randn(n, side * side, c_in, generator=g)).to(dev, torch.bfloat16)
    assert bottleneck_route(x.dtype, c_in, c_mid, c_out) == "hopper"
    before = dict(fused_bottleneck.launches_by_route)
    got = fused_bottleneck(x, folded, side, side)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches_by_route["hopper"] == before["hopper"] + 1
    assert fused_bottleneck.launches_by_route["general"] == before["general"]
    want = reference_bottleneck(x, folded, side, side)
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel <= BF16_REL_NORM, rel


@pytest.mark.parametrize("dtype, c_in, c_mid, c_out", [
    (torch.float32, 64, 64, 256),   # float32: the fp32-accuracy mode
    (torch.bfloat16, 20, 12, 36),   # widths no multiple of 64
    (torch.bfloat16, 64, 16, 64),
])
def test_bottleneck_general_route_takes_the_rest(dev, dtype, c_in, c_mid, c_out):
    folded = _folded(c_in, c_mid, c_out)
    g = torch.Generator().manual_seed(3)
    x = torch.relu(torch.randn(2, 25, c_in, generator=g)).to(dev, dtype)
    assert bottleneck_route(dtype, c_in, c_mid, c_out) == "general"
    before = dict(fused_bottleneck.launches_by_route)
    got = fused_bottleneck(x, folded, 5, 5)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches_by_route["general"] == before["general"] + 1
    assert fused_bottleneck.launches_by_route["hopper"] == before["hopper"]
    want = reference_bottleneck(x, folded, 5, 5)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        assert rel <= BF16_REL_NORM, rel


@pytest.mark.parametrize("route", ROUTES)
def test_bottleneck_launch_on_route_is_uncounted(dev, route):
    """Both routes take bfloat16 at widths that are multiples of 64, so the
    script can time one against the other; neither launch is counted."""
    folded = _folded(64, 64, 256)
    p = prepare_bottleneck(folded, torch.bfloat16, dev)
    x = torch.relu(torch.randn(2, 49, 64, device=dev)).bfloat16()
    before = (fused_bottleneck.launches, dict(fused_bottleneck.launches_by_route))
    got = launch_on_route(x, p, 7, 7, route)
    torch.cuda.synchronize()
    assert (fused_bottleneck.launches, fused_bottleneck.launches_by_route) == before
    want = reference_bottleneck(x, p, 7, 7)
    assert float((got.float() - want.float()).norm() / want.float().norm()) <= BF16_REL_NORM


def test_bottleneck_hopper_refused_launch_raises_and_leaves_no_error(dev):
    folded = _folded(64, 64, 64)
    x = torch.randn(0, 16, 64, device=dev, dtype=torch.bfloat16)  # no rows
    before = dict(fused_bottleneck.launches_by_route)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_bottleneck(x, folded, 4, 4)
    assert fused_bottleneck.launches_by_route == before
    x = torch.relu(torch.randn(2, 16, 64, device=dev)).bfloat16()
    got = fused_bottleneck(x, folded, 4, 4)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches_by_route["hopper"] == before["hopper"] + 1
    want = reference_bottleneck(x, folded, 4, 4)
    assert float((got.float() - want.float()).norm() / want.float().norm()) <= BF16_REL_NORM


def test_bottleneck_prepared_weights_load_by_tma_on_the_card(dev):
    """The Hopper route maps w1, w2_mat and w3p as they lie: contiguous,
    16-byte aligned, rows a multiple of 16 bytes."""
    p = prepare_bottleneck(_folded(64, 64, 256), torch.bfloat16, dev)
    for name in ("w1", "w2_mat", "w3p"):
        assert p[name].is_contiguous() and p[name].data_ptr() % 16 == 0
        assert p[name].shape[1] * p[name].element_size() % 16 == 0


def test_bottleneck_wrapper_refuses_what_the_kernel_does_not_take(dev):
    folded = _folded(64, 16, 64)
    x = torch.randn(2, 16, 64, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_bottleneck(x.half(), folded, 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        fused_bottleneck(x.transpose(0, 1).contiguous().transpose(0, 1), folded, 4, 4)
    with pytest.raises(ValueError, match="do not fit"):
        fused_bottleneck(torch.randn(2, 16, 32, device=dev), folded, 4, 4)


# -- B6, the tiled matmul probe -------------------------------------------------


def _probe_inputs(dev, mode, m, k, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    if mode == "int8":
        x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        y = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    else:
        x = torch.randn(m, k, generator=g).bfloat16()
        y = torch.randn(k, n, generator=g).bfloat16()
    return x.to(dev), y.to(dev)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("block", TILES)
@pytest.mark.parametrize("m, k, n", [
    (128, 128, 256),    # one or two tiles, 1 (int8) or 2 (bf16) K steps
    (256, 1024, 512),   # unequal sizes, many K steps
    (384, 384, 768),    # tile counts that are no power of two
    (1536, 256, 3072),  # more tiles than SMs: persistent blocks take a second tile
])
def test_matmul_probe_kernel_matches_plain(dev, mode, block, m, k, n):
    """int8 bit for bit; bf16 by relative norm within one bf16 ulp (the two
    sides sum the same products in float32 in another order, so an output
    rounds to a neighbouring bfloat16 now and then) and element-wise within
    two ulps of the largest output."""
    x, y = _probe_inputs(dev, mode, m, k, n)
    before = probe_matmul.launches
    got = make_probe_matmul(m, k, n, mode, block)(x, y)
    torch.cuda.synchronize()
    assert probe_matmul.launches == before + 1
    want = reference_matmul(x, y)
    assert got.dtype == want.dtype and got.shape == (m, n)
    if mode == "int8":
        assert torch.equal(got, want)
    else:
        g, w = got.float(), want.float()
        assert float((g - w).norm() / w.norm()) <= BF16_REL_NORM
        assert float((g - w).abs().max()) <= 2 * BF16_REL_NORM * float(w.abs().max())


def test_matmul_probe_int8_extremes_are_exact(dev):
    """Every product at its largest magnitude, both signs: the int32
    accumulator must hold K * 127**2 without saturating or wrapping."""
    m = k = n = 256
    x = torch.full((m, k), 127, dtype=torch.int8, device=dev)
    y = torch.full((k, n), -127, dtype=torch.int8, device=dev)
    y[:, ::2] = 127
    got = probe_matmul(x, y)
    assert torch.equal(got, reference_matmul(x, y))
    assert int(got.max()) == k * 127 * 127 and int(got.min()) == -k * 127 * 127


def test_matmul_probe_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, y = _probe_inputs(dev, "bf16", 128, 128, 256)
    with pytest.raises(ValueError, match="multiples of the tile"):
        probe_matmul(x[:100], y)
    with pytest.raises(ValueError, match="was not compiled"):
        probe_matmul(x, y, (512, 512, 512))
    with pytest.raises(TypeError, match="bfloat16 or int8"):
        probe_matmul(x.float(), y.float())
    with pytest.raises(ValueError, match="contiguous"):
        probe_matmul(x.t().contiguous().t(), y)
    with pytest.raises(ValueError, match="expected"):
        probe_matmul(x, y.cpu())
    before = probe_matmul.launches
    assert probe_matmul(x, y).shape == (128, 256)
    assert probe_matmul.launches == before + 1


# -- the graphed train step ---------------------------------------------------------------


def _graph_trainer(dev, dropout, phase=1, k=3, seed=0):
    """A small model (widths multiples of 64, so B2 and B4 take the hopper
    route), its AdamW, a grouped step of k (scan_steps) and stacked groups of
    k batches (B 4, T 8)."""
    from h36x_torch.models.phd import PHDFor3DJoints
    from h36x_torch.train.state import make_optimizer
    from h36x_torch.train.step import make_future_train_step, make_train_step

    model = PHDFor3DJoints(latent_dim=128, feature_dim=64, number_blocks=2, ar_blocks=1,
                           groups=8, regressor_hidden=128, dropout=dropout,
                           generator=torch.Generator().manual_seed(seed), device=dev)
    opt, _ = make_optimizer(model, 1e-3, phase=None if phase == 1 else phase)
    if phase == 2:
        step = make_future_train_step(model, opt, input_len=3, scan_steps=k)
    else:
        step = make_train_step(model, opt, fused=True, scan_steps=k)
    g = torch.Generator().manual_seed(seed + 1)

    def group():
        return (torch.randn(k, 4, 8, 64, generator=g).to(dev),
                (0.3 * torch.randn(k, 4, 8, 17, 3, generator=g)).to(dev),
                torch.randn(k, 4, 8, 17, 2, generator=g).to(dev),
                (1000 * torch.eye(3)).expand(k, 4, 3, 3).contiguous().to(dev))

    return model, opt, step, group


def _state(model, opt) -> list:
    from h36x_torch.train.state import optimizer_tensors

    return [*model.parameters(), *optimizer_tensors(opt)]


def _snapshot(model, opt) -> list:
    return [t.detach().clone() for t in _state(model, opt)]


def _restore(model, opt, snap) -> None:
    with torch.no_grad():
        for t, s in zip(_state(model, opt), snap):
            t.copy_(s)


@pytest.mark.parametrize("phase", [1, 2])
def test_graphed_train_step_equals_eager_steps(dev, phase):
    """k = 3 steps as one replay against the same 3 steps run eagerly from
    the same params and optimizer state: params, mu, nu, count and metrics
    bit for bit (B2 and B4 use no atomics); the first group runs eagerly
    and captures, later ones replay, and no wrapper counts a replay."""
    model, opt, step, group = _graph_trainer(dev, 0.0, phase)
    extra = (4,) if phase == 2 else ()
    first = step(group(), None, *extra)
    assert (step.eager_steps, step.graph_replays) == (3, 0)
    assert all(v.shape == (3,) and torch.isfinite(v).all() for v in first.values())
    batch = group()
    snap = _snapshot(model, opt)
    counts = (fused_gn_relu_cconv.launches, gn_relu_cconv_bwd.launches,
              fused_joint_regressor.launches, joint_regressor_bwd.launches)
    replayed = step(batch, None, *extra)
    torch.cuda.synchronize()
    assert step.graph_replays == 1 and step.eager_steps == 3
    assert counts == (fused_gn_relu_cconv.launches, gn_relu_cconv_bwd.launches,
                      fused_joint_regressor.launches, joint_regressor_bwd.launches)
    after_replay = _snapshot(model, opt)
    _restore(model, opt, snap)
    eager = step.run_eager(batch, None)
    for a, b in zip(after_replay, _state(model, opt)):
        assert torch.equal(a, b)
    for key in eager:
        assert torch.equal(replayed[key], eager[key]), key
    assert int(opt.count) == 6


def test_learning_rate_reaches_a_replay(dev):
    """set_learning_rate between two replays: the second replay's update
    equals eager steps at the new rate (and differs from the old rate's)."""
    from h36x_torch.train.state import set_learning_rate

    model, opt, step, group = _graph_trainer(dev, 0.0)
    step(group(), None)
    step(group(), None)
    batch = group()
    snap = _snapshot(model, opt)
    set_learning_rate(opt, 3e-4)
    step(batch, None)
    assert step.graph_replays == 2
    replayed = _snapshot(model, opt)
    _restore(model, opt, snap)
    set_learning_rate(opt, 3e-4)
    step.run_eager(batch, None)
    assert all(torch.equal(a, b) for a, b in zip(replayed, _state(model, opt)))
    _restore(model, opt, snap)
    set_learning_rate(opt, 1e-3)
    step.run_eager(batch, None)
    assert not all(torch.equal(a, b) for a, b in zip(replayed, _state(model, opt)))


def test_dropout_masks_differ_between_replays(dev):
    """At dropout 0.5 the generator is registered with the graph: two
    replays of one batch from the same state draw other masks (other
    losses), as two eager steps do; a mask baked in at capture would give
    the same loss twice."""
    model, opt, step, group = _graph_trainer(dev, 0.5)
    gen = torch.Generator(device=dev).manual_seed(3)
    step(group(), gen)
    batch = group()
    snap = _snapshot(model, opt)
    losses = []
    for _ in range(2):
        _restore(model, opt, snap)
        losses.append(step(batch, gen)["loss"])
    assert step.graph_replays == 2
    assert not torch.equal(losses[0], losses[1])
    eager = []
    for _ in range(2):
        _restore(model, opt, snap)
        eager.append(step.run_eager(batch, gen)["loss"])
    assert not torch.equal(eager[0], eager[1])
    with pytest.raises(ValueError, match="captured with"):
        step(batch, torch.Generator(device=dev))


def test_artifact_exported_on_the_cpu_runs_on_the_card(dev):
    """An artifact traced from CPU params loads onto the card with every
    constant there and equals the plain float32 engine on the card, bit for
    bit (the same aten ops), at batch 1 and 3; its bf16 twin within 2e-2."""
    from h36x_torch.export import export_forward, load_artifact
    from h36x_torch.infer import make_fused_forward
    from h36x_torch.models.phd import PHDFor3DJoints, param_tree

    model = PHDFor3DJoints(latent_dim=64, feature_dim=32, number_blocks=1, groups=8,
                           device="cpu")
    kw = dict(seq_len=10, feature_dim=32, groups=8)
    f32 = load_artifact(export_forward(param_tree(model), **kw))
    bf16 = load_artifact(export_forward(param_tree(model), compute_dtype=torch.bfloat16,
                                        **kw))
    assert all(t.device.type == "cuda" for t in f32.tensors() + bf16.tensors())
    plain = make_fused_forward(param_tree(model.to(dev)), groups=8, use_kernels=False,
                               precise=True)
    for b in (1, 3):
        x = torch.randn(b, 10, 32, device=dev)
        got = f32(x)
        assert got.device.type == "cuda" and torch.equal(got, plain(x))
        assert float((bf16(x) - got).abs().max()) < 2e-2


def test_fixed_batch_artifact_serves_on_the_card(dev, tmp_path, monkeypatch):
    """cli.serve --artifact of an artifact exported at a fixed batch starts on
    the card (warmed at that batch, max_batch defaulting to it, pad_to that
    batch), and its predict_fn replies what the artifact computes."""
    import h36x_torch.serve_daemon as daemon
    from h36x_torch.cli import serve as serve_cli
    from h36x_torch.export import export_forward, load_artifact, save_artifact
    from h36x_torch.models.phd import PHDFor3DJoints, param_tree

    model = PHDFor3DJoints(latent_dim=64, feature_dim=32, number_blocks=1, groups=8,
                           device="cpu")
    path = save_artifact(export_forward(param_tree(model), seq_len=10, feature_dim=32,
                                        groups=8, batch=4), tmp_path / "b4.pt2")
    got = {}

    async def fake_serve_forever(server, drain_s=10.0, **bind):
        got["server"] = server

    monkeypatch.setattr(daemon, "serve_forever", fake_serve_forever)
    serve_cli.main(["--artifact", str(path)])
    server = got["server"]
    assert (server.pad_to, server.max_batch) == (4, 4)
    feats = np.random.default_rng(0).normal(size=(4, 10, 32)).astype(np.float32)
    want = load_artifact(path)(torch.from_numpy(feats).to(dev)).cpu().numpy()
    np.testing.assert_array_equal(server.predict_fn(feats), want)


def test_bf16_model_forward_on_the_card(dev):
    """PHDFor3DJoints(dtype=bfloat16) on the card: bfloat16 out, within 2e-2
    of the float32 model from the same params; the kernels' forward ignores
    the dtype (float32, as h36x's fused path)."""
    from h36x_torch.models.phd import PHDFor3DJoints

    bf = PHDFor3DJoints(latent_dim=64, feature_dim=32, number_blocks=1, groups=8,
                        device=dev, dtype=torch.bfloat16)
    f32 = PHDFor3DJoints(latent_dim=64, feature_dim=32, number_blocks=1, groups=8,
                         device=dev)
    x = torch.randn(2, 10, 32, device=dev)
    got = bf(x, use_kernels=False)[2]
    want = f32(x, use_kernels=False)[2]
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want).abs().max()) < 2e-2
    assert torch.equal(bf(x)[2], f32(x)[2])
