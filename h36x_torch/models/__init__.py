"""Models: the PHD temporal pose model and the feature backbones, ResNet-50
(`resnet`) and ViTPose-H (`vit`)."""

from h36x_torch.models.phd import (  # noqa: F401
    CausalConv1d,
    CausalTemporalNet,
    JointRegressor,
    PHDFor3DJoints,
    ResidualBlock,
)
