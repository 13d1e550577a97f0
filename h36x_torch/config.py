"""Model configuration (counterpart of h36x/config.py, architecture part).

Only what the serving slice reads is carried over: the clip geometry
constants and the architecture fields of `ModelConfig`. The training,
extraction and mesh configs come with their slices.
"""

from __future__ import annotations

from dataclasses import dataclass

SEQ_LEN = 40  # frames per clip (after subsampling)
JOINTS_NUM = 17  # H36M 17-joint skeleton
FEATURE_DIM = 2048  # ResNet-50 pooled feature width
LATENT_DIM = 1024  # model latent ("movie strip") width


@dataclass
class ModelConfig:
    """PHD model hyper-parameters (the architecture fields of
    h36x.config.ModelConfig, same names and defaults)."""

    latent_dim: int = LATENT_DIM
    feature_dim: int = FEATURE_DIM
    joints_num: int = JOINTS_NUM
    num_blocks: int = 2  # f_movie depth
    ar_num_blocks: int = 3  # f_AR depth
    regressor_iters: int = 3
    regressor_hidden: int = 1024
    groups: int = 32
    kernel_size: int = 3
