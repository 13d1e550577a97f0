"""h36x_torch's fused bottleneck (kernel B5) on the CPU: which kernel route
each block takes, the prepared weights both routes read, and that
the plain version behind the wrapper still agrees with h36x's Pallas kernel
in interpret mode at a block whose widths take the Hopper route (layer1_0's
64 / 64 / 256, projection, 4x4 and 5x3 images) in bfloat16 and float32.
Seconds in all."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h36x.ops import pallas_bottleneck as jax_pb
from h36x_torch.ops import bottleneck as pb

# the 13 stride-1 blocks of ResNet-50 at 224 px: (blocks, side, C_in, C_mid, C_out)
STAGE_SHAPES = [("layer1_0", 56, 64, 64, 256), ("layer1_1-2", 56, 256, 64, 256),
                ("layer2_1-3", 28, 512, 128, 512), ("layer3_1-5", 14, 1024, 256, 1024),
                ("layer4_1-2", 7, 2048, 512, 2048)]
# widths that are no multiple of 64 (the odd cases of the card checks)
ODD_WIDTHS = [(64, 16, 64), (32, 16, 64), (20, 12, 36)]
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)  # one block, f32
BF16_REL_NORM = 2.0 ** -8  # one bf16 ulp (tests/test_torch_resnet.py)


def _folded(c_in, c_mid, c_out, seed=0):
    """Random folded weights as numpy float32 in h36x's layouts (1x1 as
    (C_in, C_out), the 3x3 as HWIO); a projection when C_in != C_out."""
    rng = np.random.default_rng(seed)

    def init(shape, fan_in):
        return (rng.normal(size=shape) / fan_in ** 0.5).astype(np.float32)

    def bias(c):
        return (0.1 * rng.normal(size=c)).astype(np.float32)

    f = {"w1": init((c_in, c_mid), c_in), "b1": bias(c_mid),
         "w2": init((3, 3, c_mid, c_mid), 9 * c_mid), "b2": bias(c_mid),
         "w3": init((c_mid, c_out), c_mid), "b3": bias(c_out)}
    if c_in != c_out:
        f["wp"], f["bp"] = init((c_in, c_out), c_in), bias(c_out)
    return f


@pytest.mark.parametrize("name, side, c_in, c_mid, c_out", STAGE_SHAPES)
def test_every_stage_shape_takes_the_hopper_route_in_bf16(name, side, c_in, c_mid, c_out):
    assert pb.bottleneck_route(torch.bfloat16, c_in, c_mid, c_out) == "hopper"


@pytest.mark.parametrize("c_in, c_mid, c_out",
                         [s[2:] for s in STAGE_SHAPES] + ODD_WIDTHS)
def test_float32_and_odd_widths_take_the_general_route(c_in, c_mid, c_out):
    assert pb.bottleneck_route(torch.float32, c_in, c_mid, c_out) == "general"
    want = "hopper" if all(c % 64 == 0 for c in (c_in, c_mid, c_out)) else "general"
    assert pb.bottleneck_route(torch.bfloat16, c_in, c_mid, c_out) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in, c_mid, c_out", [(64, 64, 256), (256, 64, 256), (20, 12, 36)])
def test_prepared_weights_are_the_kernels_k_by_n_matrices(dtype, c_in, c_mid, c_out):
    """The three GEMMs' weights, (K, N) row-major as both routes read them,
    rounded once from the f32 fold; h36x's layouts kept beside them."""
    folded = _folded(c_in, c_mid, c_out)
    p = pb.prepare_bottleneck(folded, dtype, "cpu")
    k3 = c_mid + (c_in if c_in != c_out else 0)
    for name, shape in (("w1", (c_in, c_mid)), ("w2_mat", (9 * c_mid, c_mid)),
                        ("w3p", (k3, c_out))):
        assert p[name].dtype == dtype and p[name].is_contiguous()
        assert tuple(p[name].shape) == shape
    assert tuple(p["w2"].shape) == (3, 3, c_mid, c_mid)
    assert torch.equal(p["w2_mat"], p["w2"].reshape(9 * c_mid, c_mid))
    w3p = np.concatenate([folded["w3"], folded["wp"]]) if "wp" in folded else folded["w3"]
    assert torch.equal(p["w3p"], torch.from_numpy(w3p).to(dtype))
    assert not any(name.endswith("_t") for name in p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h, w", [(4, 4), (5, 3)])
def test_plain_version_at_hopper_widths_matches_pallas_interpret(dtype, h, w):
    """reference_bottleneck, through the wrapper on a CPU tensor and on a
    prepared dict, against h36x's kernel in
    interpret mode, at layer1_0's widths."""
    folded = _folded(64, 64, 256, seed=1)
    x = np.maximum(np.random.default_rng(2).normal(size=(2, h * w, 64)), 0).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax_pb.fused_bottleneck(jnp.asarray(x, jdt), folded, h=h, w=w,
                                              interpret=True).astype(jnp.float32))
    prepared = pb.prepare_bottleneck(folded, dtype, "cpu")
    xt = torch.from_numpy(x).to(dtype)
    got = pb.fused_bottleneck(xt, prepared, h, w)
    assert torch.equal(got, pb.reference_bottleneck(xt, folded, h, w))
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **BLOCK_TOL)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_REL_NORM, rel


@pytest.mark.parametrize("dtype, widths", [(torch.bfloat16, (64, 64, 256)),
                                           (torch.float32, (64, 64, 256)),
                                           (torch.bfloat16, (20, 12, 36))])
def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch(dtype, widths):
    c_in, c_mid, c_out = widths
    folded = _folded(c_in, c_mid, c_out, seed=3)
    x = torch.relu(torch.randn(1, 9, c_in, generator=torch.Generator().manual_seed(4)))
    x = x.to(dtype)
    before = (pb.fused_bottleneck.launches, dict(pb.fused_bottleneck.launches_by_route))
    got = pb.fused_bottleneck(x, folded, 3, 3)
    assert (pb.fused_bottleneck.launches, pb.fused_bottleneck.launches_by_route) == before
    assert got.dtype == dtype and got.shape == (1, 9, c_out)
    assert torch.equal(got, pb.reference_bottleneck(x, folded, 3, 3))


def test_launch_counts_are_kept_per_route():
    assert set(pb.fused_bottleneck.launches_by_route) == set(pb.ROUTES)
    assert pb.ROUTES == ("general", "hopper")  # the entry point's route codes 0, 1
