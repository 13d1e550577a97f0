"""Human3.6M 17-joint skeleton: joint names, edges and left/right pairs
(counterpart of h36x/geometry/skeleton.py)."""

from __future__ import annotations

import numpy as np

NUM_JOINTS = 17

# The 17 joints in model order.
H36M_JOINT_NAMES = (
    "pelvis",
    "r_hip", "r_knee", "r_ankle",
    "l_hip", "l_knee", "l_ankle",
    "spine", "thorax", "nose", "head",
    "l_shoulder", "l_elbow", "l_wrist",
    "r_shoulder", "r_elbow", "r_wrist",
)

# Indices into the raw 32-joint H36M pose arrays selecting the 17-joint subset.
H36M_RAW_JOINT_IDS = (0, 1, 2, 3, 6, 7, 8, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27)

# Skeleton bone edges, 16 total, as (parent, child) joint indices.
H36M_EDGES = (
    (0, 1), (1, 2), (2, 3),
    (0, 4), (4, 5), (5, 6),
    (0, 7), (7, 8), (8, 9), (9, 10),
    (8, 11), (11, 12), (12, 13),
    (8, 14), (14, 15), (15, 16),
)

# Left/right mirrored joint pairs swapped during horizontal flips.
H36M_FLIP_PAIRS = (
    (1, 4),    # hips
    (2, 5),    # knees
    (3, 6),    # ankles
    (14, 11),  # shoulders
    (15, 12),  # elbows
    (16, 13),  # wrists
)


def edge_index_arrays() -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) int32 arrays of the 16 skeleton edges for vectorized bone math."""
    src = np.array([e[0] for e in H36M_EDGES], dtype=np.int32)
    dst = np.array([e[1] for e in H36M_EDGES], dtype=np.int32)
    return src, dst


def flip_permutation(num_joints: int = NUM_JOINTS) -> np.ndarray:
    """Joint permutation that swaps left and right in one gather."""
    perm = np.arange(num_joints, dtype=np.int32)
    for a, b in H36M_FLIP_PAIRS:
        perm[a], perm[b] = b, a
    return perm
