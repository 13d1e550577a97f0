"""The readers of the program's extraction spans: three shares of the
window's calls' host seconds, from the calls the program keeps, and two
ratios within its process-wide table, on hand-made calls and tables; and
each reports in a traced run of the extraction cell on the CPU."""

from __future__ import annotations

from collections import defaultdict

import pytest

from portbench import harness
from portbench.tests.conftest import bench, tiny_cell

SHARES = {"feed_wait_share.extract": ["h36x.extract.wait_jobs"],
          "scheduler_host_share.extract": ["h36x.extract.stage", "h36x.extract.drain"],
          "store_wait_share.extract": ["h36x.extract.store"]}
RATIOS = ("worker_ms.extract", "backbone_load_s.extract")
TABLE_READERS = (*SHARES, *RATIOS)
CALL = {"h36x.extract.call": 10.0, "h36x.extract.wait_jobs": 3.0,
        "h36x.extract.stage": 0.25, "h36x.extract.drain": 0.5,
        "h36x.extract.store": 0.2, "h36x.extract.feature_fn": 0.4}
# set-up's warm call: one video, the kernels' first build
WARM = {"h36x.extract.call": 30.0, "h36x.extract.feature_fn": 20.0,
        "h36x.extract.wait_jobs": 1.0, "h36x.extract.stage": 1.0,
        "h36x.extract.store": 1.0}
# a traced run's record: the readers need a trace, not what it holds
TRACED = {"trace": {"busy_s": 1.0, "window_s": 10.0,
                    "idle_gaps": [["h36x.extract.wait_jobs", 6.0]]}}


def _read(name, rec):
    return harness.read_metric(name, rec)


def _gain(spans: dict) -> dict:
    """One measured call's gain, as `profiling.measured` keeps it."""
    return {"host_s": {n: (s, 1) for n, s in spans.items()}, "counts": {}}


def test_the_new_metrics_are_entries_for_the_extraction_cell():
    entries = {m["name"]: m for m in bench()["per_layer"]}
    for name in TABLE_READERS:
        assert entries[name]["workloads"] == ["resnet50.extract-opt"]
        assert entries[name]["moves"] == "extract_clips_per_s"
        assert entries[name]["source"] == "program_span"
        assert (harness.HERE / "metrics" / f"{name}.py").is_file()


@pytest.fixture
def table(monkeypatch):
    """A fresh process-wide table of the program's spans and counters, and
    no measured calls."""
    from h36x_torch.utils import profiling
    from h36x_torch.utils.timers import PhaseTimers

    fresh = PhaseTimers()
    monkeypatch.setattr(profiling, "_TABLE", fresh)
    monkeypatch.setattr(profiling, "_CALLS", defaultdict(list))
    return fresh


@pytest.fixture
def calls(table):
    """The measured extraction calls the readers see, oldest first."""
    from h36x_torch.utils import profiling

    return profiling._CALLS["h36x.extract.call"]


@pytest.mark.parametrize("name, want", [("feed_wait_share.extract", 30.0),
                                        ("scheduler_host_share.extract", 7.5),
                                        ("store_wait_share.extract", 2.0)])
def test_shares_sum_their_spans_over_the_window_calls(calls, name, want):
    half = {span: seconds / 2 for span, seconds in CALL.items()}
    calls.extend([_gain(WARM), _gain(half), _gain(half)])
    assert _read(name, TRACED) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(SHARES))
def test_shares_leave_out_the_warm_call(calls, name):
    calls.append(_gain(WARM))
    assert _read(name, TRACED) is None
    calls.append(_gain(CALL))
    assert _read(name, TRACED) == pytest.approx(
        100.0 * sum(CALL[s] for s in SHARES[name]) / CALL["h36x.extract.call"])


@pytest.mark.parametrize("name", sorted(SHARES))
def test_shares_read_zero_without_their_spans_and_none_without_a_trace(calls, name):
    """The trace's idle labels do not enter a share: only the calls do."""
    calls.extend([_gain(WARM), _gain({span: seconds for span, seconds in CALL.items()
                                      if span not in SHARES[name]})])
    assert _read(name, TRACED) == 0.0
    assert _read(name, {"trace": None}) is None
    assert _read(name, {}) is None


def test_table_readers_on_a_hand_made_table(table):
    for _ in range(4):
        table.add("h36x.extract.job", 0.5)
    table.count("h36x.extract.frames_cropped", 1000)
    table.add("h36x.extract.load_backbone", 1.0)
    table.add("h36x.extract.load_backbone", 2.0)
    assert _read("worker_ms.extract", TRACED) == pytest.approx(2.0)
    assert _read("backbone_load_s.extract", TRACED) == pytest.approx(1.5)
    # outside a traced run neither reports
    assert _read("worker_ms.extract", {}) is None
    assert _read("backbone_load_s.extract", {"trace": None}) is None


@pytest.mark.parametrize("name", TABLE_READERS)
def test_table_readers_give_none_on_an_empty_table(table, name):
    assert _read(name, TRACED) is None


@pytest.mark.parametrize("name", TABLE_READERS)
def test_table_readers_give_none_on_a_program_without_the_table(monkeypatch, name):
    from h36x_torch.utils import profiling

    monkeypatch.delattr(profiling, "totals")
    monkeypatch.delattr(profiling, "measured_calls")
    assert _read(name, TRACED) is None


def test_a_tiny_extraction_fills_the_table_readers(table, tmp_path):
    """The extraction cell's driver on the CPU at a tiny size: every reader
    reports from what its calls recorded, each share within 0-100 %."""
    import torch

    cell = tiny_cell("resnet50.extract-opt")
    driver = harness.load_module(harness.HERE / "drivers" / "extract.py", "t_span_extract")
    run = harness.Run(cell=cell, seed=2**31 + 5, seconds=0.0, trace=False,
                      device=torch.device("cpu"), t_start=0.0, workdir=tmp_path / "w")
    run.workdir.mkdir()
    out = driver.run(run)
    assert out.correct
    rec = dict(out.record, trace={"busy_s": 1.0, "window_s": 10.0, "idle_gaps": []})
    spans = table.snapshot()["spans"]
    assert spans["h36x.extract.load_backbone"][1] >= 2  # the warm call and the window's
    assert _read("worker_ms.extract", rec) > 0.0
    assert _read("backbone_load_s.extract", rec) > 0.0
    shares = [_read(name, rec) for name in SHARES]
    assert all(0.0 < v < 100.0 for v in shares)
    assert sum(shares) < 100.0
