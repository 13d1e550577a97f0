"""Probe: what is the tensor cores' int8 rate against their bf16 rate on one
hand-written tiled matmul?

Counterpart of benchmarks/int8_pallas_probe.py on an NVIDIA GPU:

    python -m h36x_torch.benchmarks.int8_kernel_probe --size 4096 --iters 24

Four measurements on the same inputs (numpy, seed 0):
  - library bf16: torch.matmul        (cuBLAS, the yardstick for the kernel)
  - kernel  bf16 x bf16 -> f32 -> bf16 (h36x_torch/ops/csrc/matmul_probe.cu:
                                        TMA + wgmma, persistent)
  - kernel  int8 x int8 -> int32       (the same mainloop: the question; the
                                        call includes y's transposition)
  - library int8: torch._int_mm       (cuBLASLt, the int8 yardstick)

--block BM BN picks the kernel's compiled tile (default (128, 256)); the K
step is one 128-byte swizzle row (64 bf16, 128 int8).

Timing: CUDA events around `iters` back-to-back launches on one stream, the
best of 6 such bursts after a warm-up burst. Any failure raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from h36x_torch.ops.matmul_probe import TILES, make_probe_matmul, tile_index
from h36x_torch.utils.runtime import resolve_device

MODES = ("library_bf16", "kernel_bf16", "kernel_int8", "library_int8")


def time_best(run, iters: int, bursts: int = 6) -> float:
    """Seconds per call of `run`: the best of `bursts` bursts of `iters`
    back-to-back calls, timed with CUDA events, after one warm-up burst."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for burst in range(bursts + 1):
        start.record()
        for _ in range(iters):
            run()
        end.record()
        end.synchronize()
        if burst > 0:
            best = min(best, start.elapsed_time(end) / iters / 1e3)
    return best


def make_inputs(mode: str, m: int, k: int, n: int, device):
    """The probe's inputs: int8 uniform in [-127, 127], bf16 standard normal,
    from numpy's default_rng(0)."""
    rng = np.random.default_rng(0)
    if mode.endswith("int8"):
        x = torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8))
        y = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8))
    else:
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).bfloat16()
        y = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).bfloat16()
    return x.to(device), y.to(device)


def bench(mode: str, m: int = 4096, k: int = 4096, n: int = 4096, iters: int = 24,
          block=None):
    """(seconds per call, TFLOP/s or TOP/s) of one of MODES on the GPU; it
    raises without one (the probe times GPU kernels)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    device = resolve_device("cuda")
    x, y = make_inputs(mode, m, k, n, device)
    if mode == "library_bf16":
        mm = torch.matmul
    elif mode == "library_int8":
        mm = torch._int_mm
    else:
        mm = make_probe_matmul(m, k, n, mode.removeprefix("kernel_"), block)
    dt = time_best(lambda: mm(x, y), iters)
    return dt, 2 * m * k * n / dt / 1e12


def main(argv=None):
    """Prints one line per mode; returns {mode: (seconds, rate)}."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--size", type=int, default=4096)
    p.add_argument("--iters", type=int, default=24)
    p.add_argument("--block", type=int, nargs=2, default=list(TILES[0]),
                   metavar=("BM", "BN"),
                   help=f"the kernel's tile, one of the compiled {TILES}")
    args = p.parse_args(argv)
    tile_index(args.block)  # refuse a tile that was not compiled, before any run
    s = args.size
    results = {}
    for mode in MODES:
        dt, rate = bench(mode, s, s, s, args.iters, args.block)
        unit = "TOPS" if mode.endswith("int8") else "TFLOPS"
        print(f"{mode:12s}: {dt*1e3:7.3f} ms  {rate:7.1f} {unit}", flush=True)
        results[mode] = (dt, rate)
    return results


if __name__ == "__main__":
    main()
