"""Ops of the serving path: each holds a plain PyTorch version and the
wrapper of its hand-written Hopper kernel (CUDA C++ under `csrc/`, built at
first use by :mod:`h36x_torch.ops._build`)."""
