"""Ops of the serving path: each holds a plain PyTorch version and the
wrapper of its hand-written Hopper kernel (CUDA C++ under `csrc/`, built at
first use by :mod:`h36x_torch.ops._build`)."""

from h36x_torch.ops.causal_conv import causal_conv1d  # noqa: F401
from h36x_torch.ops.resize import resize_bilinear  # noqa: F401
