"""Training subsystem: losses and metrics, AdamW, steps, checkpoints, loop."""

from h36x_torch.train.losses import bone_length_loss, mpjpe, mse3d  # noqa: F401
