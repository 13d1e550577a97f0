"""Seeds of the run's draws and the serving cells' clip bank, in plain
Python and NumPy: the load generator's child process imports this and not
torch, so that its own garbage collection stays short."""

from __future__ import annotations

import hashlib

import numpy as np


def sub_seed(seed: int, *names) -> int:
    """A 63-bit seed for the draw `names` of the run `seed` (any integer)."""
    h = hashlib.blake2b(repr((int(seed), *names)).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def clip_bank(seed: int, count: int, seq_len: int, feature_dim: int) -> np.ndarray:
    """`count` distinct (seq_len, feature_dim) float32 feature clips in [0, 1)."""
    rng = np.random.default_rng(sub_seed(seed, "clip-bank"))
    return rng.random((count, seq_len, feature_dim), dtype=np.float32)
