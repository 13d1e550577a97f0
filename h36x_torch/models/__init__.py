"""Models: the PHD temporal pose model and the feature backbones, ResNet-50
(`resnet`), ViTPose-H (`vit`) and HRNet-W48 (`hrnet`), the last two reading
their crops through `crops`."""

from h36x_torch.models.phd import (  # noqa: F401
    CausalConv1d,
    CausalTemporalNet,
    JointRegressor,
    PHDFor3DJoints,
    ResidualBlock,
)
