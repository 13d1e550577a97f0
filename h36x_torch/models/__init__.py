"""Models: the PHD temporal pose model and the ResNet-50 feature backbone."""

from h36x_torch.models.phd import (  # noqa: F401
    CausalConv1d,
    CausalTemporalNet,
    JointRegressor,
    PHDFor3DJoints,
    ResidualBlock,
)
