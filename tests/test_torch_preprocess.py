"""h36x_torch's device crop-resize front ends and resize_bilinear against
h36x on the CPU (atol 1e-5): the host grids and matrices bit for bit, the
matrix form with per-clip matrices batched over leading dims, the gather
form, the two forms against each other, and both against torch's bilinear
interpolate of the cropped frames (as tests/test_preprocess.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from h36x.ops import preprocess as jax_pre
from h36x.ops import resize as jax_resize
from h36x_torch.ops import preprocess as pre
from h36x_torch.ops.resize import resize_bilinear

TOL = dict(rtol=0.0, atol=1e-5)


@pytest.mark.parametrize("start, size, in_size, out_size", [
    (10, 50, 100, 32), (0, 16, 16, 16), (3, 7, 20, 11), (90, 40, 100, 24), (0, 1000, 1000, 224)])
def test_grids_and_matrices_are_h36x_s(start, size, in_size, out_size):
    for a, b in zip(pre.crop_resize_grid(start, size, in_size, out_size),
                    jax_pre.crop_resize_grid(start, size, in_size, out_size)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pre.crop_resize_matrix(start, size, in_size, out_size),
                                  jax_pre.crop_resize_matrix(start, size, in_size, out_size))
    box, h, w = (start, 1, size, size), in_size, in_size + 1
    for a, b in zip(pre.crop_resize_matrices(box, h, w, out_size),
                    jax_pre.crop_resize_matrices(box, h, w, out_size)):
        np.testing.assert_array_equal(a, b)


def test_matrix_form_matches_h36x_batched_per_clip(rng):
    frames = rng.integers(0, 256, size=(2, 3, 40, 48, 3)).astype(np.uint8)
    boxes = [(4, 6, 30, 30), (0, 10, 36, 36)]
    mats = [pre.crop_resize_matrices(b, 40, 48, 16) for b in boxes]
    wy, wx = np.stack([m[0] for m in mats]), np.stack([m[1] for m in mats])
    got = pre.fused_crop_resize(torch.from_numpy(frames), wy, wx)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 16, 16, 3)
    want = jax_pre.fused_crop_resize(jnp.asarray(frames), jnp.asarray(wy), jnp.asarray(wx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for b in range(2):
        single = pre.fused_crop_resize(torch.from_numpy(frames[b]),
                                       torch.from_numpy(mats[b][0]), mats[b][1])
        np.testing.assert_allclose(single.numpy(), got[b].numpy(), **TOL)
    assert got.min() >= 0.0 and got.max() <= 1.0 + 1e-6


def test_gather_form_matches_h36x_and_the_matrix_form(rng):
    frames = rng.integers(0, 256, size=(3, 40, 48, 3)).astype(np.uint8)
    box = (4, 6, 30, 30)
    gy, gx = pre.crop_resize_grids(box, 40, 48, 16)
    got = pre.fused_crop_resize_gather(torch.from_numpy(frames), gy, gx)
    want = jax_pre.fused_crop_resize_gather(
        jnp.asarray(frames), tuple(jnp.asarray(g) for g in gy),
        tuple(jnp.asarray(g) for g in gx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    wy, wx = pre.crop_resize_matrices(box, 40, 48, 16)
    matrix = pre.fused_crop_resize(torch.from_numpy(frames), wy, wx)
    np.testing.assert_allclose(got.numpy(), matrix.numpy(), **TOL)
    # rank-agnostic: one image, and float input
    one = pre.fused_crop_resize_gather(torch.from_numpy(frames[0]).double(), gy, gx)
    np.testing.assert_allclose(one.numpy(), got[0].numpy(), **TOL)


def test_front_ends_match_torch_interpolate_of_the_crop(rng):
    frames = rng.integers(0, 256, size=(3, 40, 48, 3)).astype(np.uint8)
    box, out = (4, 6, 30, 30), 16
    crop = frames[:, box[0]:box[0] + box[2], box[1]:box[1] + box[3], :]
    t = torch.from_numpy(np.transpose(crop, (0, 3, 1, 2))).float()
    want = F.interpolate(t, size=(out, out), mode="bilinear", align_corners=False,
                         antialias=False).permute(0, 2, 3, 1) / 255.0
    wy, wx = pre.crop_resize_matrices(box, 40, 48, out)
    gy, gx = pre.crop_resize_grids(box, 40, 48, out)
    for got in (pre.fused_crop_resize(torch.from_numpy(frames), wy, wx),
                pre.fused_crop_resize_gather(torch.from_numpy(frames), gy, gx)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape, out_hw", [((2, 3, 20, 24), (11, 13)),
                                           ((4, 7, 9), (14, 5)), ((16, 16), (16, 16))])
def test_resize_bilinear_matches_h36x_and_torch(rng, shape, out_hw):
    img = rng.normal(size=shape).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(img), *out_hw)
    want = jax_resize.resize_bilinear(jnp.asarray(img), *out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    t = torch.from_numpy(img).reshape(-1, 1, *shape[-2:])
    ref = F.interpolate(t, size=out_hw, mode="bilinear", align_corners=False,
                        antialias=False).reshape(*shape[:-2], *out_hw)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


def test_imagenet_normalize(rng):
    v = rng.random((2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(pre.imagenet_normalize(torch.from_numpy(v)).numpy(),
                               np.asarray(jax_pre.imagenet_normalize(jnp.asarray(v))),
                               rtol=1e-6, atol=1e-6)
