"""The harness finds everything by name: a configuration, a cell, a driver
and a per-layer metric added as files alone, plus their BENCHMARK.json
entries, run without an edit to a file that is there. And the result's
line, the metrics a cell reports, and the refusals of the entry point."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness, readers
from portbench import run as prun
from portbench.tests.conftest import bench


def _copy(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_new_config_cell_driver_and_metric_are_found_from_files(tmp_path):
    root = _copy(tmp_path)
    (root / "configs" / "toy.json").write_text(json.dumps({"width": 3}))
    (root / "workloads" / "toy.count.json").write_text(json.dumps(
        {"driver": "toy", "n": 5, "why": "counts"}))
    (root / "drivers" / "toy.py").write_text(
        "from portbench.harness import Outcome\n"
        "def run(run):\n"
        "    n = run.cell.spec['n'] * run.cell.config['width']\n"
        "    return Outcome(setup_s=0.5, e2e={'toy_per_s': float(n)}, record={'n': n},\n"
        "                   attempted=n, failed=0, checks=[('gap', 0.0, 1.0)])\n")
    (root / "metrics" / "toy_share.toy.py").write_text(
        "def read(rec):\n    return 100.0 * rec['n'] / 30\n")
    b = bench()
    b["configs"].append({"name": "toy", "source": "https://example.org/toy",
                         "file": "portbench/configs/toy.json", "reduced": [], "why": "toy"})
    b["workloads"].append({"name": "toy.count", "config": "toy", "traffic": "count",
                           "chips": 1, "why": "toy"})
    b["end_to_end"].append({"name": "toy_per_s", "unit": "1/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["toy.count"]})
    b["per_layer"].append({"name": "toy_share.toy", "unit": "%", "better": "higher",
                           "source": "program_counter", "layer": "toy", "moves": "toy_per_s"})
    cell = harness.Cell.find(b, "toy.count", root=root)
    assert cell.config == {"width": 3} and cell.spec["n"] == 5
    assert sorted(cell.e2e) == ["setup_s", "toy_per_s"]
    assert cell.per_layer == ["toy_share.toy"]
    driver = harness.load_module(root / "drivers" / "toy.py", "toy_driver")
    out = driver.run(harness.Run(cell, 1, 1.0, False, torch.device("cpu"), 0.0, tmp_path))
    assert out.e2e == {"toy_per_s": 15.0} and out.correct
    assert harness.read_metric("toy_share.toy", out.record, root=root) == 50.0
    # the cells already there keep their metrics
    assert harness.Cell.find(b, "resnet50.extract-opt", root=root).per_layer == [
        m["name"] for m in b["per_layer"] if "resnet50.extract-opt" in m.get("workloads", [])]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    b = bench()
    for w in b["workloads"]:
        cell = harness.Cell.find(b, w["name"])
        assert "setup_s" in cell.e2e and len(cell.e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for name in cell.per_layer:
            assert (harness.HERE / "metrics" / f"{name}.py").is_file()


def test_result_line_ends_with_the_checks_and_carries_the_contract_keys():
    cell = harness.Cell.find(bench(), "resnet50.extract-opt")
    out = harness.Outcome(setup_s=3.0, e2e={"extract_clips_per_s": 100.0},
                          record={"window_s": 2.0, "dedup_ratio": 7.44}, attempted=4,
                          failed=0, checks=[("feature_gap", 1e-3, 1.5e-2)])
    line = prun.result_line(cell, out, False, {"platform": "gpu"})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["metrics"] == {"extract_clips_per_s": {"value": 100.0, "unit": "clips/s"},
                               "setup_s": {"value": 3.0, "unit": "s"}}
    traced = prun.result_line(cell, out, True, {"platform": "gpu"})
    # no trace: the readers of the trace find nothing and are left out
    assert traced["metrics"] == {"dedup_ratio.extract": {"value": 7.44, "unit": "x"}}
    bad = harness.Outcome(3.0, {}, {}, 1, 0, [("loss_gap", 2e-4, 1e-4)])
    assert not bad.correct
    assert not harness.Outcome(3.0, {}, {}, 1, 0, [("loss_gap", float("nan"), 1.0)]).correct


def test_readers_return_nothing_without_a_trace_and_shares_below_100():
    assert readers.mfu({}) is None and readers.device_roofline({}) is None
    assert readers.idle_share({"trace": None}) is None
    rec = {"traced_flops": 989e12 * 0.5, "traced_window_s": 1.0, "traced_bound_s": 0.25,
           "trace": {"busy_s": 0.5, "window_s": 1.0}}
    assert readers.mfu(rec) == pytest.approx(50.0)
    assert readers.device_roofline(rec) == pytest.approx(50.0)
    assert readers.idle_share(rec) == pytest.approx(50.0)


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["h36x_torch", "h36x_torch.ops", "numpy", "jaxtyping", "flaxen"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["h36x.ops.temporal", "jax", "jaxlib.xla",
                                              "flax.linen"]) == [
        "flax.linen", "h36x.ops.temporal", "jax", "jaxlib.xla"]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    code = ("import sys, pkgutil, importlib, portbench\n"
            "from portbench import harness\n"
            "for m in ['portbench.run', 'portbench.harness', 'portbench.rules', 'portbench.synth',\n"
            "          'portbench.trace', 'portbench.roofline', 'portbench.loadgen',\n"
            "          'portbench.controls', 'portbench.sweep_serve',\n"
            "          'portbench.reference.phd', 'portbench.reference.resnet50']:\n"
            "    importlib.import_module(m)\n"
            "for d in ['train', 'serve', 'extract']:\n"
            "    harness.load_module(harness.HERE / 'drivers' / f'{d}.py', 'd_' + d)\n"
            "import h36x_torch.train.loop, h36x_torch.serve_daemon, h36x_torch.extract.pipeline\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.HERE.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "import portbench.reference.phd, portbench.reference.resnet50, portbench.rules\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('h36x_torch', 'h36x', 'jax', 'jaxlib', 'flax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.HERE.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_point_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "resnet50.extract-opt", "--seed", str(2**33 + 1), "--seconds", "1",
                          "--trace", "0"], cwd=harness.HERE.parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_entry_point_refuses_outside_a_checkout_of_the_program(tmp_path):
    shutil.copy(harness.HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "resnet50.extract-opt", "--seed", "7", "--seconds", "1",
                          "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
