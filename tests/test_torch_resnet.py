"""h36x_torch's ResNet-50, its fused bottleneck (kernel B5; on the CPU the
wrapper runs the plain version) and the folded `opt` engine against h36x on
the CPU, from the same numpy-seeded inputs and weights (carried over by
params_from_flax): the module against flax `ResNet50.apply`, a
torchvision-layout state_dict through both packages, the BN folds, the
plain bottleneck against h36x's Pallas kernel in interpret mode (the cases
of tests/test_pallas_bottleneck.py), the fused forward and the folded
engine. Small sizes (32-64 px inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h36x.extract.pipeline import make_feature_fn as jax_make_feature_fn
from h36x.models.resnet import Bottleneck as FlaxBottleneck
from h36x.models.resnet import ResNet50 as FlaxResNet50
from h36x.models.resnet import init_resnet_params
from h36x.models.torch_import import convert_torch_resnet50
from h36x.ops import pallas_bottleneck as jax_pb
from h36x.ops import resnet_opt as jax_opt
from h36x_torch.extract.pipeline import make_feature_fn
from h36x_torch.models.resnet import ResNet50, load_torchvision, params_from_flax
from h36x_torch.ops import bottleneck as pb
from h36x_torch.ops import resnet_opt

TOL = dict(rtol=2e-3, atol=2e-3)  # whole-network f32 (test_pallas_bottleneck.py)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)  # one block, f32
# bfloat16, one block: both sides sum the same bf16 products in f32 in
# another order, so a rounded `a`, `b` or output lands on the neighbouring
# bf16 value now and then; one bf16 ulp (2^-8) bounds the relative norm
BF16_REL_NORM = 2.0 ** -8
# bfloat16, the whole folded network: the same rounding of every block,
# compounded over 16 blocks (about 5e-3 between two engines on the CPU); a
# wrong weight, block or pixel is off by O(1)
BF16_BACKBONE_REL_NORM = 2e-2


def _randomize_stats(variables, rng):
    """Fresh-init BN statistics are mean 0 / var 1 and the affine 1 / 0;
    randomize all four so that a folding or mapping error shows."""

    def rand(path, leaf):
        name = str(path[-1].key)
        if name == "mean":
            return rng.normal(0.0, 0.05, leaf.shape).astype(np.float32)
        return rng.uniform(0.8, 1.3, leaf.shape).astype(np.float32)

    def affine(path, leaf):
        name = str(path[-1].key)
        if name == "scale":
            return rng.uniform(0.8, 1.2, leaf.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        return np.asarray(leaf, np.float32)

    return {"params": jax.tree_util.tree_map_with_path(affine, jax.device_get(variables["params"])),
            "batch_stats": jax.tree_util.tree_map_with_path(
                rand, jax.device_get(variables["batch_stats"]))}


@pytest.fixture(scope="module")
def backbone():
    """One flax ResNet-50 (f32) with randomized BN, as numpy variables, and
    the port's module carrying the same weights."""
    rng = np.random.default_rng(0)
    model = FlaxResNet50()
    variables = _randomize_stats(
        jax.jit(lambda k: init_resnet_params(model, k, input_hw=32))(jax.random.key(0)),
        rng)
    port = ResNet50(device="cpu")
    port.load_state_dict(params_from_flax(variables))
    return model, variables, port


def torchvision_state_dict(seed: int = 0) -> dict:
    """A torchvision resnet50 state_dict (its key names and shapes, fc head
    included) with seeded random values: He-scaled convs, BN affine and
    running statistics away from their init values."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = torch.from_numpy(
            (rng.normal(size=(o, i, k, k)) * (2.0 / (o * k * k)) ** 0.5).astype(np.float32))

    def bn(name, c):
        sd[f"{name}.weight"] = torch.from_numpy(rng.uniform(0.8, 1.2, c).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32))
        sd[f"{name}.running_mean"] = torch.from_numpy(rng.normal(0, 0.05, c).astype(np.float32))
        sd[f"{name}.running_var"] = torch.from_numpy(rng.uniform(0.8, 1.3, c).astype(np.float32))
        sd[f"{name}.num_batches_tracked"] = torch.tensor(100)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    c_in = 64
    for stage, blocks in enumerate((3, 4, 6, 3)):
        w = 64 * 2 ** stage
        for b in range(blocks):
            p = f"layer{stage + 1}.{b}"
            conv(f"{p}.conv1", w, c_in, 1)
            bn(f"{p}.bn1", w)
            conv(f"{p}.conv2", w, w, 3)
            bn(f"{p}.bn2", w)
            conv(f"{p}.conv3", 4 * w, w, 1)
            bn(f"{p}.bn3", 4 * w)
            if b == 0:
                conv(f"{p}.downsample.0", 4 * w, c_in, 1)
                bn(f"{p}.downsample.1", 4 * w)
            c_in = 4 * w
    sd["fc.weight"] = torch.from_numpy(rng.normal(size=(1000, 2048)).astype(np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def test_module_matches_flax_apply(backbone):
    model, variables, port = backbone
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(variables, x))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_torchvision_state_dict_loads_like_h36x_converts_it():
    sd = torchvision_state_dict()
    port = load_torchvision(ResNet50(seed=5, device="cpu"), sd)
    model = FlaxResNet50()
    variables = convert_torch_resnet50(sd)
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(variables, x))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(KeyError, match="not a ResNet-50"):
        load_torchvision(ResNet50(device="cpu"), {k: v for k, v in sd.items() if "layer4.2" not in k})


def test_folds_match_h36x(backbone):
    """The port folds from its module exactly as h36x folds from the flax
    variables (same float32 arithmetic, bit for bit); the s2d stem's bias map
    is a float32 convolution on both sides."""
    _, variables, port = backbone
    want, (want_k, want_b) = jax_pb.fold_resnet50(variables)
    got, (got_k, got_b) = pb.fold_resnet50(port)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        for k in want[name]:
            np.testing.assert_array_equal(got[name][k].numpy(), np.asarray(want[name][k]))
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    k2, bias_map = resnet_opt.fold_stem_s2d(got_k, got_b, hw=32)
    jk2, jbias = jax_opt.fold_stem_s2d(want_k, want_b, hw=32)
    np.testing.assert_array_equal(k2.numpy(), jk2)
    np.testing.assert_allclose(bias_map.numpy(), jbias, rtol=1e-5, atol=1e-5)


def test_space_to_depth_matches_h36x():
    x = np.random.default_rng(3).integers(0, 256, size=(2, 8, 6, 3)).astype(np.uint8)
    np.testing.assert_array_equal(resnet_opt.space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_opt.space_to_depth(jnp.asarray(x))))


def _block(seed, cin, width, shape):
    """A flax stride-1 Bottleneck with randomized BN, its folded weights
    (h36x's fold), and a seeded input of `shape` (B, H, W, C_in)."""
    rng = np.random.default_rng(seed)
    block = FlaxBottleneck(width, strides=1)
    x = rng.normal(size=shape).astype(np.float32)
    variables = _randomize_stats(block.init(jax.random.key(seed), jnp.asarray(x)), rng)
    return jax_pb.fold_bottleneck(variables["params"], variables["batch_stats"]), x


@pytest.mark.parametrize("case, cin, width, shape, force_rows", [
    ("identity", 256, 64, (2, 8, 8, 256), None),
    ("projection", 64, 16, (2, 8, 8, 64), None),
    ("boundary_pixels", 64, 16, (1, 4, 4, 64), None),
    ("multi_strip", 64, 16, (2, 16, 8, 64), 4),
    ("multi_strip_coarse_halo", 64, 16, (1, 8, 4, 64), 4),
    ("odd_9x9", 64, 16, (1, 9, 9, 64), None),
])
def test_bottleneck_matches_pallas_interpret(case, cin, width, shape, force_rows):
    """The whole map, edges included, against h36x's kernel in interpret
    mode (single strip, or its multi-strip halo path via force_rows)."""
    folded, x = _block(len(case), cin, width, shape)
    b, h, w, _ = shape
    want = np.asarray(jax_pb.fused_bottleneck(
        jnp.asarray(x.reshape(b, h * w, cin)), folded, h=h, w=w, interpret=True,
        force_rows=force_rows))
    before = pb.fused_bottleneck.launches
    got = pb.fused_bottleneck(torch.from_numpy(x.reshape(b, h * w, cin)), folded, h, w)
    assert pb.fused_bottleneck.launches == before  # the plain version on the CPU
    np.testing.assert_allclose(got.numpy(), want, **BLOCK_TOL)


def test_bottleneck_bf16_matches_pallas_interpret():
    folded, x = _block(7, 256, 64, (2, 8, 8, 256))
    xb = x.reshape(2, 64, 256)
    want = np.asarray(jax_pb.fused_bottleneck(
        jnp.asarray(xb, jnp.bfloat16), folded, h=8, w=8, interpret=True)).astype(np.float32)
    got = pb.fused_bottleneck(torch.from_numpy(xb).bfloat16(), folded, 8, 8)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_REL_NORM, rel


def test_resnet50_fused_forward_matches_h36x(backbone):
    _, variables, port = backbone
    x = np.random.default_rng(4).normal(size=(2, 64, 64, 3)).astype(np.float32)
    folded, stem = jax_pb.fold_resnet50(variables)
    want = np.asarray(jax_pb.resnet50_fused_forward(jnp.asarray(x), folded, stem,
                                                    interpret=True))
    got = pb.resnet50_fused_forward(torch.from_numpy(x), *pb.fold_resnet50(port))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_opt_engine_matches_h36x_opt_engine(backbone):
    """make_feature_fn(engine='opt') on raw u8 frames, against h36x's
    (tests/test_extract.py::test_feature_fn_opt_engine_matches_flax), and
    against the port's own plain engine."""
    model, variables, port = backbone
    frames = np.random.default_rng(5).integers(0, 256, size=(3, 32, 32, 3)).astype(np.uint8)
    want = np.asarray(jax_make_feature_fn(model, engine="opt")(variables, jnp.asarray(frames)))
    got = make_feature_fn(port, engine="opt")(torch.from_numpy(frames)).numpy()
    assert got.shape == (3, 2048)
    np.testing.assert_allclose(got, want, **TOL)
    plain = make_feature_fn(port, engine="flax")(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, plain, **TOL)
    with pytest.raises(ValueError, match="engine"):
        make_feature_fn(port, engine="xla")


def test_bf16_opt_engine_folds_float32_like_h36x(backbone):
    """A bfloat16 module keeps its float32 values for the fold, so every
    folded weight rounds to bfloat16 once, as h36x folds its float32
    params: the folds agree bit for bit, and the two bfloat16 `opt` engines
    agree by relative norm."""
    model, variables, _ = backbone
    port = ResNet50(dtype=torch.bfloat16, device="cpu")
    port.load_state_dict(params_from_flax(variables))
    assert next(port.parameters()).dtype == torch.bfloat16
    want_f, _ = jax_pb.fold_resnet50(variables)
    got_f, _ = pb.fold_resnet50(port.float32_state())
    for name in want_f:
        for k in want_f[name]:
            np.testing.assert_array_equal(got_f[name][k].numpy(), np.asarray(want_f[name][k]))
    frames = np.random.default_rng(6).integers(0, 256, size=(3, 32, 32, 3)).astype(np.uint8)
    want = np.asarray(jax_make_feature_fn(FlaxResNet50(dtype=jnp.bfloat16), engine="opt")(
        variables, jnp.asarray(frames)))
    got = make_feature_fn(port, engine="opt")(torch.from_numpy(frames)).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_BACKBONE_REL_NORM, rel


def test_resnet50_without_a_device_asks_for_cuda():
    """ResNet50() resolves its device as the port's other entry points do:
    cuda unless the caller names another, and on a host without CUDA that
    raises, naming the CPU option, before any weight is drawn."""
    if torch.cuda.is_available():
        assert next(ResNet50(stage_sizes=(1,)).parameters()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResNet50()
    assert next(ResNet50(stage_sizes=(1,), device="cpu").parameters()).device.type == "cpu"
