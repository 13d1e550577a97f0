"""The reader of the feed's counter `h36x.extract.jobs_ready`: the share of
the video workers' jobs that the consumer found already queued, over the
window's calls, on hand-made calls; None where it has nothing to read; and
a report in a traced run of the extraction cell on the CPU."""

from __future__ import annotations

from collections import defaultdict

import pytest

from portbench import harness
from portbench.tests.conftest import bench, tiny_cell

READY = "feed_ready_share.extract"
CALL = {"h36x.extract.call": 10.0, "h36x.extract.wait_jobs": 3.0}
# set-up's warm call: one video, the kernels' first build
WARM = {"h36x.extract.call": 30.0, "h36x.extract.wait_jobs": 1.0}
# a traced run's record: the reader needs a trace, not what it holds
TRACED = {"trace": {"busy_s": 1.0, "window_s": 10.0, "idle_gaps": []}}


def _read(rec):
    return harness.read_metric(READY, rec)


def _gain(spans: dict, jobs: int = 0, ready: int = 0) -> dict:
    """One measured call's gain, as `profiling.measured` keeps it, with
    `jobs` worker jobs of which `ready` were found queued."""
    host = {n: (s, 1) for n, s in spans.items()}
    if jobs:
        host["h36x.extract.job"] = (0.01 * jobs, jobs)
    return {"host_s": host,
            "counts": {"h36x.extract.jobs_ready": ready} if ready else {}}


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
    """The measured extraction calls the reader sees, oldest first."""
    from h36x_torch.utils import profiling

    return profiling._CALLS["h36x.extract.call"]


def test_the_ready_share_is_a_counter_of_the_feed_layer():
    entries = {m["name"]: m for m in bench()["per_layer"]}
    assert entries[READY]["source"] == "program_counter"
    assert entries[READY]["unit"] == "%"
    assert entries[READY]["workloads"] == ["resnet50.extract-opt"]
    assert entries[READY]["moves"] == "extract_clips_per_s"
    assert entries[READY]["layer"] == entries["feed_wait_share.extract"]["layer"]
    assert (harness.HERE / "metrics" / f"{READY}.py").is_file()


def test_the_ready_share_counts_ready_jobs_over_the_window_calls_jobs(calls):
    # the warm call's jobs, all found ready, are left out
    calls.extend([_gain(WARM, jobs=93, ready=93), _gain(CALL, jobs=372, ready=279),
                  _gain(CALL, jobs=372)])
    assert _read(TRACED) == pytest.approx(100.0 * 279 / 744)


@pytest.mark.parametrize("window", [
    [],                                        # no call but the warm one
    [_gain(CALL, jobs=372)],                   # a program whose feed has no counter
    [_gain(CALL)],                             # no job
])
def test_the_ready_share_gives_none_where_it_has_nothing_to_read(calls, window):
    calls.extend([_gain(WARM, jobs=93, ready=93), *window])
    assert _read(TRACED) is None


def test_the_ready_share_gives_none_outside_a_traced_run(calls, monkeypatch):
    calls.extend([_gain(WARM, jobs=93, ready=93), _gain(CALL, jobs=372, ready=100)])
    assert _read({}) is None
    assert _read({"trace": None}) is None
    from h36x_torch.utils import profiling

    monkeypatch.delattr(profiling, "measured_calls")
    assert _read(TRACED) is None


def test_a_tiny_extraction_reports_the_ready_share(table, tmp_path):
    """The extraction cell's driver on the CPU at a tiny size: the reader
    reports from what the window's calls counted, within 0-100 %."""
    import torch

    cell = tiny_cell("resnet50.extract-opt")
    driver = harness.load_module(harness.HERE / "drivers" / "extract.py", "t_ready_extract")
    run = harness.Run(cell=cell, seed=2**31 + 7, seconds=0.0, trace=False,
                      device=torch.device("cpu"), t_start=0.0, workdir=tmp_path / "w")
    run.workdir.mkdir()
    out = driver.run(run)
    assert out.correct
    rec = dict(out.record, trace=TRACED["trace"])
    assert 0.0 < _read(rec) <= 100.0
