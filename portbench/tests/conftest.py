"""Shared fixtures of the benchmark's tests: tiny configurations that the
CPU runs in seconds, and the card's presence decided inside a fixture."""

from __future__ import annotations

import pytest
import torch

from portbench import harness

TINY_PHD = dict(feature_dim=64, latent_dim=64, groups=8, ar_num_blocks=1,
                regressor_hidden=64, seq_len=8, batch_size=8, shard_size=16)
TINY_EXTRACT = dict(videos=2, frames=24, raw=96, seq_len=8, stride=4, resize=64,
                    batch_size=2, num_workers=2)


def bench() -> dict:
    return harness.load_json(harness.HERE.parent / "BENCHMARK.json")


def tiny_cell(name: str) -> harness.Cell:
    """The cell whose file is portbench/workloads/<name>.json, at a size the
    CPU runs quickly (listed in BENCHMARK.json or not)."""
    cell = harness.Cell.from_file(name)
    if cell.config_name == "phd":
        cell.config.update(TINY_PHD)
    else:
        cell.spec.update(TINY_EXTRACT)
    if cell.spec["driver"] == "serve":
        cell.spec.update(rate=100.0, grace=5.0, bank=8)
    return cell


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark's readings are the card's)")
    return torch.device("cuda", 0)
