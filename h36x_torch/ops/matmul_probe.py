"""Tiled tensor-core matmul probe: bf16 x bf16 -> bf16 and int8 x int8 -> int32.

Counterpart of benchmarks/int8_pallas_probe.py::make_pallas_matmul (the
tiled kernel whose int8 rate the probe holds against its bf16 rate).

- :func:`reference_matmul` is the plain PyTorch version: bf16 as a float32
  product (TF32 off) rounded once to bfloat16; int8 exactly, in int32.
- :func:`probe_matmul` is the wrapper of the CUDA kernel
  `csrc/matmul_probe.cu` (TMA + wgmma, warp-specialised, persistent): on
  CUDA tensors it launches the kernel and counts the launch in
  `probe_matmul.launches`; on CPU tensors it runs the plain version; on any
  other device it raises. :func:`make_probe_matmul` fixes the sizes, the
  mode and the tile first, as `make_pallas_matmul` does.

A tile is (bm, bn); the K step is one 128-byte swizzle row, `BK[mode]`
elements (64 bf16, 128 int8). M, N and K must be multiples of the tile.
The int8 mode transposes y into a workspace inside the call (wgmma's s8
form reads K-major operands only): two launches, counted as one call.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from h36x_torch.ops import _build

# the tiles (bm, bn) compiled into csrc/matmul_probe.cu, by index; the first
# is the default
TILES = ((128, 256), (128, 128))
MODES = {"bf16": (torch.bfloat16, torch.bfloat16), "int8": (torch.int8, torch.int32)}
BK = {"bf16": 64, "int8": 128}  # K elements of one 128-byte swizzle row


def reference_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version. bfloat16: float32 accumulation in full float32 (TF32
    off), one rounding to bfloat16. int8: the exact int32 product; CUDA has
    no integer matmul, so there it runs in float64, which is exact while
    K * 127**2 < 2**53."""
    if x.dtype == torch.bfloat16 and y.dtype == torch.bfloat16:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return (x.float() @ y.float()).to(torch.bfloat16)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    if x.dtype == torch.int8 and y.dtype == torch.int8:
        if x.device.type == "cpu":
            return x.int() @ y.int()
        return (x.double() @ y.double()).to(torch.int32)
    raise TypeError(f"reference_matmul takes bfloat16 or int8 pairs, not "
                    f"{x.dtype} and {y.dtype}")


def tile_index(block: Optional[Sequence[int]]) -> int:
    """Index of the compiled tile (bm, bn) = `block` (None: the default);
    any other tile is refused."""
    if block is None:
        return 0
    block = tuple(int(v) for v in block)
    if block not in TILES:
        raise ValueError(f"tile {block} was not compiled; choose one of {TILES}")
    return TILES.index(block)


def _mode_of(x: torch.Tensor, y: torch.Tensor) -> str:
    for mode, (in_dtype, _) in MODES.items():
        if x.dtype == in_dtype and y.dtype == in_dtype:
            return mode
    raise TypeError(f"probe_matmul takes bfloat16 or int8 pairs, not {x.dtype} "
                    f"and {y.dtype}")


def _check_sizes(m: int, k: int, n: int, tile: int, mode: str) -> None:
    (bm, bn), bk = TILES[tile], BK[mode]
    if min(m, k, n) <= 0 or m % bm or k % bk or n % bn:
        raise ValueError(f"sizes ({m}, {k}, {n}) must be positive multiples of "
                         f"the tile (bm, bk, bn) = ({bm}, {bk}, {bn}) in {mode}")


def _launch(x, y, mode: str, tile: int) -> torch.Tensor:
    (m, k), n = x.shape, y.shape[1]
    for name, t in (("x", x), ("y", y)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"probe_matmul: {name} is on {t.device}, expected "
                             f"{x.device} (cuda)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"probe_matmul: {name} must be contiguous and "
                             "16-byte aligned")
    out = torch.empty((m, n), device=x.device, dtype=MODES[mode][1])
    # int8: y transposed to (N, K) here, inside the call
    y_ws = torch.empty((n, k), device=x.device, dtype=torch.int8) if mode == "int8" else None
    (lib,) = _build.load("matmul_probe")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.h36x_matmul_probe(x.data_ptr(), y.data_ptr(),
                                   None if y_ws is None else y_ws.data_ptr(),
                                   out.data_ptr(), m, k, n, list(MODES).index(mode),
                                   tile, stream)
    _build.check(rc, f"probe_matmul ({mode}, tile {TILES[tile]})")
    probe_matmul.launches += 1
    return out


def probe_matmul(x: torch.Tensor, y: torch.Tensor,
                 block: Optional[Sequence[int]] = None) -> torch.Tensor:
    """x (M, K) . y (K, N), both row-major: bfloat16 pairs give bfloat16
    (float32 accumulator), int8 pairs give int32. M and N must be multiples
    of the tile `block` = (bm, bn), one of TILES, and K of BK[mode]."""
    mode = _mode_of(x, y)
    tile = tile_index(block)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} are not "
                         "(M, K) and (K, N)")
    _check_sizes(x.shape[0], x.shape[1], y.shape[1], tile, mode)
    if x.device.type == "cpu" and y.device.type == "cpu":
        return reference_matmul(x, y)
    return _launch(x, y, mode, tile)


probe_matmul.launches = 0  # kernel launches on CUDA tensors


def make_probe_matmul(m: int, k: int, n: int, mode: str,
                      block: Optional[Sequence[int]] = None):
    """(x (m, k), y (k, n)) -> x . y through :func:`probe_matmul`, with the
    sizes, the mode ("bf16" or "int8") and the tile checked once, here."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {tuple(MODES)}")
    tile = tile_index(block)
    _check_sizes(m, k, n, tile, mode)

    def mm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if (tuple(x.shape), tuple(y.shape)) != ((m, k), (k, n)) or _mode_of(x, y) != mode:
            raise ValueError(f"made for {mode} ({m}, {k}) . ({k}, {n}); got "
                             f"{x.dtype} {tuple(x.shape)} . {y.dtype} {tuple(y.shape)}")
        return probe_matmul(x, y, TILES[tile])

    return mm
