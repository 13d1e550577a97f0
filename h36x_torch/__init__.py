"""h36x_torch — the PyTorch/CUDA port of h36x for NVIDIA Hopper (H100).

The JAX package `h36x` stays the reference; this package grows beside it
slice by slice and keeps its module names, so every module here has a
counterpart of the same name under `h36x/`. It imports torch, numpy and the
standard library only — never jax, flax, msgpack or anything of `h36x`.

Parameters keep the flax names and layouts (Dense kernels (in, out), conv
kernels (K, D, O)), so a flax param tree converts to a `state_dict` and back
bit for bit (:func:`h36x_torch.models.phd.params_from_flax`), and checkpoints
move between the two packages in flax's msgpack format.

Entry points (the serving daemon, `h36x_torch.cli.serve`, and the phase-1
trainer, `h36x_torch.cli.train`) run on `cuda` unless the caller passes
`device="cpu"`. On a CUDA tensor every kernel op launches its hand-written
Hopper kernel, forward and backward (:mod:`h36x_torch.ops`); on a CPU
tensor it runs the op's plain PyTorch version.
"""

from h36x_torch.config import FEATURE_DIM, JOINTS_NUM, LATENT_DIM, SEQ_LEN, ModelConfig

__all__ = ["FEATURE_DIM", "JOINTS_NUM", "LATENT_DIM", "SEQ_LEN", "ModelConfig"]
