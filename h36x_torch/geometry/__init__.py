"""Camera, crop and skeleton geometry (counterpart of h36x/geometry):
pure functions, torch for the projections and numpy on the host."""

from h36x_torch.geometry.skeleton import (  # noqa: F401
    H36M_EDGES,
    H36M_FLIP_PAIRS,
    H36M_JOINT_NAMES,
    H36M_RAW_JOINT_IDS,
    NUM_JOINTS,
    edge_index_arrays,
)
from h36x_torch.geometry.camera import (  # noqa: F401
    adjust_camera_after_crop_and_resize,
    intrinsics_matrix,
    project_point_radial,
    project_with_K,
    rotation_matrix_xyz,
)
from h36x_torch.geometry.crop import (  # noqa: F401
    adjust_joints2d_after_crop_and_resize,
    compute_square_crop_from_2d,
)
