"""Host-side visualization tools (numpy + matplotlib, imported lazily)."""

from h36x_torch.viz.anim import (  # noqa: F401
    plot_batch_sample,
    plot_batch_sample_2d_2dproj_3d,
    plot_batch_sample_2d_2dproj_3d_no_video,
    plot_sequence_3d,
    to_uint8_rgb,
)
