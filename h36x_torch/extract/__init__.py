"""Feature-extraction stage: decode, crop, ResNet-50 -> feature shards."""

from h36x_torch.extract.writer import AsyncWriter  # noqa: F401
