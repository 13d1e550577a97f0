"""Shared utilities: phase timers, device selection, msgpack."""

from h36x_torch.utils.timers import PhaseTimers  # noqa: F401
