"""h36x_torch's matmul probe against the TPU probe's Pallas kernel on the
CPU: `reference_matmul` (the plain version the CUDA kernel is held against
on the card) against `_matmul_kernel` of benchmarks/int8_pallas_probe.py in
interpret mode, at 256^3 with 128 tiles (two K steps, so the accumulator
carries across grid steps), in both modes. The test builds its own
`pallas_call` around the kernel body with the grid and specs of
`make_pallas_matmul`, which takes no `interpret` argument. int8 must be
equal; bf16 within one bf16 ulp of the value (both sides accumulate in
float32 and round once). Also the wrapper's CPU behaviour and what it
refuses."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarks.int8_pallas_probe import _matmul_kernel
from h36x_torch.benchmarks import int8_kernel_probe
from h36x_torch.ops.matmul_probe import (
    BK,
    MODES,
    TILES,
    make_probe_matmul,
    probe_matmul,
    reference_matmul,
    tile_index,
)


def _pallas_matmul_interpret(m, k, n, acc_dtype, out_dtype, bm=128, bk=128, bn=128):
    """make_pallas_matmul's call (grid, specs, scratch) in interpret mode."""
    k_steps = k // bk
    kernel = partial(_matmul_kernel, k_steps=k_steps, out_dtype=out_dtype)
    return pl.pallas_call(
        kernel,
        grid=(m // bm, n // bn, k_steps),
        in_specs=[pl.BlockSpec((bm, bk), lambda i, j, kk: (i, kk)),
                  pl.BlockSpec((bk, bn), lambda i, j, kk: (kk, j))],
        out_specs=pl.BlockSpec((bm, bn), lambda i, j, kk: (i, j)),
        out_shape=jax.ShapeDtypeStruct((m, n), out_dtype),
        scratch_shapes=[pltpu.VMEM((bm, bn), acc_dtype)],
        interpret=True,
    )


def _inputs(mode, m, k, n):
    return [np.asarray(t.float() if mode == "bf16" else t)
            for t in int8_kernel_probe.make_inputs(f"kernel_{mode}", m, k, n, "cpu")]


def test_reference_matmul_int8_equals_the_pallas_kernel():
    x, y = _inputs("int8", 256, 256, 256)
    want = _pallas_matmul_interpret(256, 256, 256, jnp.int32, jnp.int32)(
        jnp.asarray(x), jnp.asarray(y))
    got = reference_matmul(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.abs(np.asarray(want)).max() > 127 * 127  # sums, not single products


def test_reference_matmul_bf16_within_one_ulp_of_the_pallas_kernel():
    x, y = _inputs("bf16", 256, 256, 256)
    xj, yj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    want = _pallas_matmul_interpret(256, 256, 256, jnp.float32, jnp.bfloat16)(xj, yj)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = reference_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # one bf16 ulp of a value v is at most 2^-7 |v|; below the smallest normal
    # scale seen here (sums of 256 products) no output is that small
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-30)
    assert np.mean(got == want) > 0.99  # and nearly every output is the same value


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_wrapper_runs_the_plain_version_on_cpu_tensors(mode):
    x, y = int8_kernel_probe.make_inputs(f"kernel_{mode}", 128, 128, 256, "cpu")
    before = probe_matmul.launches
    got = make_probe_matmul(128, 128, 256, mode)(x, y)
    assert probe_matmul.launches == before  # no kernel was launched
    assert torch.equal(got, reference_matmul(x, y))
    assert got.dtype == (torch.bfloat16 if mode == "bf16" else torch.int32)


def test_wrapper_refuses_sizes_tiles_and_types():
    x = torch.zeros(128, 128, dtype=torch.int8)
    y = torch.zeros(128, 256, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of the tile"):
        probe_matmul(x[:100], y)
    with pytest.raises(ValueError, match="multiples of the tile"):
        make_probe_matmul(4096, 4096, 4000, "int8")
    with pytest.raises(ValueError, match="was not compiled"):
        tile_index((512, 512, 512))
    with pytest.raises(ValueError, match="was not compiled"):
        tile_index((128, 64, 128))  # the earlier design's (bm, bk, bn)
    with pytest.raises(ValueError, match="not .M, K. and .K, N."):
        probe_matmul(x, y.t())
    with pytest.raises(TypeError, match="bfloat16 or int8"):
        probe_matmul(x.float(), y.float())
    with pytest.raises(TypeError, match="bfloat16 or int8"):
        reference_matmul(x, y.bfloat16())
    with pytest.raises(ValueError, match="one of"):
        make_probe_matmul(128, 128, 128, "fp8")
    with pytest.raises(ValueError, match="made for int8"):
        make_probe_matmul(128, 128, 256, "int8")(x.bfloat16(), y.bfloat16())
    assert [tile_index(t) for t in TILES] == list(range(len(TILES)))
    assert tile_index(None) == 0


def test_probe_entry_point_raises_without_a_gpu():
    """The probe times GPU kernels: no CPU fallback, and a tile that was not
    compiled is refused before anything runs."""
    with pytest.raises(ValueError, match="was not compiled"):
        int8_kernel_probe.main(["--block", "512", "512"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        int8_kernel_probe.main(["--size", "256", "--iters", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        int8_kernel_probe.bench("kernel_int8", 128, 128, 128, 1)


def test_probe_inputs_follow_the_tpu_probe():
    """default_rng(0): int8 uniform in [-127, 127], bf16 standard normal, x
    drawn before y, as benchmarks/int8_pallas_probe.py::bench draws them."""
    rng = np.random.default_rng(0)
    x, y = int8_kernel_probe.make_inputs("kernel_int8", 8, 16, 8, "cpu")
    np.testing.assert_array_equal(x.numpy(), rng.integers(-127, 128, size=(8, 16)))
    np.testing.assert_array_equal(y.numpy(), rng.integers(-127, 128, size=(16, 8)))
    rng = np.random.default_rng(0)
    x, y = int8_kernel_probe.make_inputs("library_bf16", 8, 16, 8, "cpu")
    want = np.asarray(jnp.asarray(rng.normal(size=(8, 16)), jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(x.float().numpy(), want)


def test_tiles_are_the_wgmma_designs():
    """(bm, bn) with two 64-row consumer warpgroups and BN one wgmma wide;
    the K step one 128-byte swizzle row of the mode's element."""
    assert TILES == ((128, 256), (128, 128))
    assert {mode: BK[mode] * MODES[mode][0].itemsize for mode in MODES} == \
        {"bf16": 128, "int8": 128}
    assert tile_index(None) == 0 and tile_index([128, 128]) == 1


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("tile", TILES)
def test_sizes_that_divide_the_tile_pass_and_others_raise(mode, tile):
    bm, bn = tile
    bk = BK[mode]
    make_probe_matmul(bm, bk, bn, mode, tile)
    make_probe_matmul(3 * bm, 5 * bk, 2 * bn, mode, tile)
    for m, k, n in ((bm + 64, bk, bn), (bm, bk + bk // 2, bn), (bm, bk, bn + 64),
                    (0, bk, bn)):
        with pytest.raises(ValueError, match="multiples of the tile"):
            make_probe_matmul(m, k, n, mode, tile)
    x, y = int8_kernel_probe.make_inputs(f"kernel_{mode}", bm, bk, bn, "cpu")
    assert torch.equal(probe_matmul(x, y, tile), reference_matmul(x, y))
