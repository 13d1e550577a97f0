"""Human3.6M 17-joint skeleton edges (counterpart of
h36x/geometry/skeleton.py, the part the losses read)."""

from __future__ import annotations

import numpy as np

NUM_JOINTS = 17

# Skeleton bone edges, 16 total, as (parent, child) joint indices.
H36M_EDGES = (
    (0, 1), (1, 2), (2, 3),
    (0, 4), (4, 5), (5, 6),
    (0, 7), (7, 8), (8, 9), (9, 10),
    (8, 11), (11, 12), (12, 13),
    (8, 14), (14, 15), (15, 16),
)


def edge_index_arrays() -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) int32 arrays of the 16 skeleton edges for vectorized bone math."""
    src = np.array([e[0] for e in H36M_EDGES], dtype=np.int32)
    dst = np.array([e[1] for e in H36M_EDGES], dtype=np.int32)
    return src, dst
