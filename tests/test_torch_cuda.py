"""h36x_torch CUDA kernels against their plain versions on the card, at
small odd shapes that the serving shapes do not reach (ragged tiles, group
sizes, tap counts, widths that are no multiple of a tile), plus what the
wrappers refuse. Marked `cuda`: they skip without a GPU. On a machine with
one, and without jax, run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from h36x_torch.ops.regressor import _reference_forward, fused_joint_regressor
from h36x_torch.ops.temporal import fused_gn_relu_cconv, reference_gn_relu_cconv

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-4)  # FP32 on both sides; sums reordered


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
    got = fused_gn_relu_cconv(*args, groups=groups)
    torch.cuda.synchronize()
    assert fused_gn_relu_cconv.launches == before + 1
    want = reference_gn_relu_cconv(*args, groups=groups)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("n, d, h, p, iters", [
    (37, 96, 200, 51, 3),
    (5, 1000, 64, 30, 2),
    (16, 64, 2300, 51, 1),
    (100, 128, 256, 64, 4),
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
    got = fused_joint_regressor(*ws, iters, p)
    torch.cuda.synchronize()
    assert fused_joint_regressor.launches == before + 1
    torch.testing.assert_close(got, _reference_forward(*ws, iters, p), **TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, scale, bias, w, cb, _ = _temporal(dev, 2, 4, 64, 64, 3, 8, False)
    with pytest.raises(TypeError, match="float32"):
        fused_gn_relu_cconv(x.double(), scale, bias, w, cb, groups=8)
    with pytest.raises(ValueError, match="contiguous"):
        fused_gn_relu_cconv(x.transpose(0, 1).contiguous().transpose(0, 1),
                            scale, bias, w, cb, groups=8)
    with pytest.raises(ValueError, match="expected cuda"):
        fused_gn_relu_cconv(x, scale.cpu(), bias, w, cb, groups=8)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_gn_relu_cconv(x, scale.requires_grad_(), bias, w, cb, groups=8)
    phi = torch.randn(4, 64, device=dev)

    def weights(h):
        return [torch.zeros(64 + 51, h, device=dev), torch.zeros(h, device=dev),
                torch.zeros(h, h, device=dev), torch.zeros(h, device=dev),
                torch.zeros(h, 51, device=dev), torch.zeros(51, device=dev)]

    before = fused_joint_regressor.launches
    # at H=2400 the block's activations outgrow its shared memory
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_joint_regressor(phi, *weights(2400), 3, 51)
    assert fused_joint_regressor.launches == before
    # the refused launch leaves no error behind for the next one
    assert fused_joint_regressor(phi, *weights(64), 3, 51).shape == (4, 51)
