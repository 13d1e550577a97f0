"""The HRNet-W48 cell (hrnet_w48.extract-256x192) on the CPU at a tiny size:
its entries, the roofline units against counts made by hand, the
benchmark's reference against the program and the tests' copy, the cell's
whole run sound and with a fault planted underneath (the check has to come
out false), the fp8 control, and every new reader on hand-made records."""

from __future__ import annotations

import dataclasses
import math
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench import roofline as r
from portbench import roofline_hrnet as rh
from portbench.reference import hrnet_w48 as ref_hrnet
from portbench.reference.lower import fp8_cast
from portbench.tests.conftest import TINY_EXTRACT, bench

CELL = "hrnet_w48.extract-256x192"
NEW = ("mfu.hrnet", "device_roofline.hrnet", "idle_share.hrnet", "branch_roofline.hrnet",
       "fuse_roofline.hrnet", "backbone_load_s.hrnet")
TINY_WIDTHS = dict(img_size=[128, 96], crop_size=128, stem_channels=16, stage1_blocks=1,
                   stage1_width=8, branch_channels=[8, 16, 32, 64], num_modules=[1, 1, 1],
                   num_blocks=1, head_channels=[4, 8, 16, 32], feature_dim=64)
FULL = dict(img_size=(256, 192), stem=64, stage1_blocks=4, stage1_width=64,
            channels=(48, 96, 192, 384), modules=(1, 4, 3), blocks=4, head=(32, 64, 128, 256),
            feature=2048, eps=1e-5)


def _driver():
    return harness.load_module(harness.HERE / "drivers" / "extract_hrnet.py",
                               "test_driver_extract_hrnet")


@pytest.fixture
def tiny(monkeypatch):
    """(driver, run) of the cell at a tiny size, the program's HRNet-W48 at
    the same tiny widths."""
    from h36x_torch.models import hrnet

    cell = harness.Cell.from_file(CELL)
    cell.spec.update(TINY_EXTRACT, resize=128)
    cell.config.update(TINY_WIDTHS)
    monkeypatch.setattr(hrnet, "HRNET_W48", ref_hrnet.sizes(cell.config))
    run = harness.Run(cell, 2**33 + 7, 0.5, False, torch.device("cpu"), time.perf_counter(),
                      harness.Run.workdir_for(CELL))
    return _driver(), run


def _checks(out) -> dict:
    return {n: v for n, v, _ in out.checks}


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


# ---------------------------------------------------------------- entries

def test_the_cell_config_and_metrics_are_entries():
    b = bench()
    cell = harness.Cell.find(b, CELL)
    assert cell.chips == 1 and cell.spec["driver"] == "extract_hrnet"
    assert sorted(cell.e2e) == ["extract_clips_per_s", "setup_s"]
    assert sorted(cell.per_layer) == sorted(NEW)
    entries = {m["name"]: m for m in b["per_layer"]}
    for name in NEW:
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "extract_clips_per_s"
        assert (harness.HERE / "metrics" / f"{name}.py").is_file()
    assert ref_hrnet.sizes(cell.config) == FULL
    cfg = {c["name"]: c for c in b["configs"]}["hrnet_w48"]
    assert cfg["reduced"] == ["decode", "videos_per_job"] == sorted(cell.config["reduced"])
    # the new entries come last, the cells before keep what they had
    assert [w["name"] for w in b["workloads"]][-1] == CELL
    assert [m["name"] for m in b["per_layer"]][-len(NEW):] == list(NEW)
    vit = harness.Cell.find(b, "vitpose_h.extract-256x192")
    assert cell.spec == dict(vit.spec, config="hrnet_w48", driver="extract_hrnet",
                             backbone="hrnet_w48", why=cell.spec["why"],
                             limits=cell.spec["limits"])
    for other in ("resnet50.extract-opt", "vitpose_h.extract-256x192"):
        assert harness.Cell.find(b, other).per_layer == [
            m["name"] for m in b["per_layer"] if other in m.get("workloads", [])]


def test_the_configuration_holds_the_program_s_published_widths():
    from h36x_torch.models import hrnet

    cfg = harness.Cell.find(bench(), CELL).config
    s = ref_hrnet.sizes(cfg)
    assert s == hrnet.HRNET_W48
    specs = ref_hrnet.param_specs(s)
    assert cfg["parameters"] == sum(math.prod(sh) for n, sh, _ in specs
                                    if "running_" not in n) == 75_420_864
    assert cfg["convolutions"] == sum(k == "conv" for _, _, k in specs) == 325
    assert cfg["fuse_paths"] == ref_hrnet.fuse_paths(s) == 62
    assert cfg["feature_dim"] == 2048 and cfg["raw_frame"] == 1000
    assert cfg["branch_sizes"] == [[256 // 4 >> i, 192 // 4 >> i] for i in range(4)]
    assert cfg["gflop_per_frame"] == pytest.approx(
        r.total_flops(rh.hrnet_units(1, s)) / 1e9, abs=0.01)


# ---------------------------------------------------------------- roofline

def test_units_by_hand_at_a_small_size():
    s = dict(img_size=(32, 32), stem=2, stage1_blocks=1, stage1_width=1, channels=(2, 4),
             modules=(1,), blocks=1, head=(1, 2), feature=3, eps=1e-5)
    u = {x.name: x for x in rh.hrnet_units(3, s)}
    assert list(u) == ["stem", "transition1", "stage2.0.branches", "stage2.0.fuse", "head"]
    # stem: 3 -> 2 at 16 x 16, 2 -> 2 at 8 x 8, a Bottleneck 2 -> 1 -> 4 with
    # its projected shortcut at 8 x 8; weights with their norms' 4 vectors
    bottleneck = 2 * 64 + 9 * 64 + 4 * 64 + 8 * 64
    assert u["stem"].flops == 2 * 3 * (3 * 2 * 9 * 256 + 2 * 2 * 9 * 64 + bottleneck)
    w_bottleneck = (2 + 4) + (9 + 4) + (4 + 16) + (8 + 16)
    assert u["stem"].nbytes == 3 * 32 * 32 * 3 + ((54 + 8) + (36 + 8) + w_bottleneck) * 2 \
        + 3 * 4 * 64 * 2
    # transition1: 4 -> 2 at 8 x 8 (a kept branch's width), 4 -> 4 s2 at 4 x 4
    assert u["transition1"].flops == 2 * 3 * (4 * 2 * 9 * 64 + 4 * 4 * 9 * 16)
    assert u["transition1"].nbytes == 3 * 256 * 2 + ((72 + 8) + (144 + 16)) * 2 \
        + 3 * (2 * 64 + 4 * 16) * 2
    streams = 2 * 64 + 4 * 16
    assert u["stage2.0.branches"].flops == 2 * 3 * (2 * 36 * 64 + 2 * 144 * 16)
    assert u["stage2.0.branches"].nbytes == 2 * 3 * streams * 2 \
        + (2 * (36 + 8) + 2 * (144 + 16)) * 2
    # 1x1 4 -> 2 at 4 x 4 (then upsampled), 3x3 s2 2 -> 4 at 4 x 4
    assert u["stage2.0.fuse"].flops == 2 * 3 * (8 * 16 + 2 * 4 * 9 * 16)
    assert u["stage2.0.fuse"].nbytes == 2 * 3 * streams * 2 + ((8 + 8) + (72 + 16)) * 2
    # head: Bottlenecks 2 -> 1 -> 4 at 8 x 8 and 4 -> 2 -> 8 at 4 x 4, downsamp
    # 4 -> 8 s2 (bias) at 4 x 4, final 8 -> 3 (bias) at 4 x 4
    assert u["head"].flops == 2 * 3 * (bottleneck + (8 + 36 + 16 + 32) * 16
                                       + 4 * 8 * 9 * 16 + 8 * 3 * 16)
    w_head = w_bottleneck + (16 + 44 + 48 + 64) + (288 + 8 + 32) + (24 + 3 + 12)
    assert u["head"].nbytes == 3 * streams * 2 + w_head * 2 + 3 * 3 * 4
    assert [x.name for x in rh.branch_units(3, s)] == ["stage2.0.branches"]
    assert [x.name for x in rh.fuse_units(3, s)] == ["stage2.0.fuse"]


def test_published_widths_count_33_8_gflop_a_frame():
    units = rh.hrnet_units(1, FULL)
    assert r.total_flops(units) == 33_846_755_328  # 16.92 G multiply-adds
    assert len(units) == 1 + 3 + 8 + 8 + 1
    share = {}
    for x in units:
        part = x.name.split(".")[-1].rstrip("123")
        share[part] = share.get(part, 0.0) + x.flops / r.total_flops(units)
    assert share == pytest.approx({"stem": 0.0592, "transition": 0.0339,
                                   "branches": 0.7829, "fuse": 0.0626, "head": 0.0613},
                                  abs=5e-4)
    # a call's 6,000 frames in dispatches of 480 and a last of 240
    batches = _driver().dispatch_sizes(6000, 13, 480)
    assert batches == {480: 12, 240: 1}
    flops, bound = r.over_batches(lambda n: rh.hrnet_units(n, FULL), batches)
    assert flops == pytest.approx(6000 * 33.85e9, rel=1e-3)
    assert 0.2 < bound < 0.22


def test_dispatch_sizes_refuse_counts_that_do_not_add_up():
    d = _driver()
    assert d.dispatch_sizes(480, 1, 480) == {480: 1}
    assert d.dispatch_sizes(100, 1, 480) == {100: 1}
    for frames, dispatches in ((6000, 12), (6000, 14), (0, 1), (10, 0)):
        with pytest.raises(RuntimeError):
            d.dispatch_sizes(frames, dispatches, 480)


# --------------------------------------------------------------- reference

def _tiny_weights(seed=7):
    s = ref_hrnet.sizes(dict(TINY_WIDTHS, bn_eps=1e-5))
    return s, ref_hrnet.make_weights(s, torch.Generator().manual_seed(seed), "cpu")


def test_the_benchmark_reference_matches_the_program_at_a_tiny_size():
    from h36x_torch.models import hrnet

    s, w = _tiny_weights()
    x = torch.randint(0, 256, (9, 128, 128, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(8))
    want = ref_hrnet.forward(w, x, s)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        model = hrnet.load_hrnet(hrnet.HRNet(dtype=dtype, **s), w, "cpu")
        with torch.inference_mode():
            assert _rel(model(x), want) <= tol
    # the fp8 control's arithmetic moves it far more than bfloat16
    assert _rel(ref_hrnet.forward(w, x, s, cast=fp8_cast), want) > 2e-2


def test_the_tests_reference_and_the_benchmark_s_agree():
    from tests import hrnet_reference as tests_ref

    s, w = _tiny_weights()
    w2 = tests_ref.make_weights(s, torch.Generator().manual_seed(7), "cpu")
    assert w.keys() == w2.keys() and all(torch.equal(w[k], w2[k]) for k in w)
    assert tests_ref.param_specs(s) == ref_hrnet.param_specs(s)
    x = torch.randint(0, 256, (3, 128, 128, 3), dtype=torch.uint8)
    torch.testing.assert_close(ref_hrnet.forward(w, x, s), tests_ref.forward(w2, x, s))
    assert tests_ref.fuse_paths(FULL) == ref_hrnet.fuse_paths(FULL) == 62


# ------------------------------------------------------------- whole runs

def test_sound_run_is_correct(tiny):
    driver, run = tiny
    out = driver.run(run)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    proof = out.proof
    assert proof["hrnet_frames"] == proof["backbone_frames"] > 0
    assert proof["fuse_paths"] == 20 * proof["dispatches"] > 0
    assert _checks(out)["feature_gap"] > 0


def test_the_reference_in_the_programs_place_is_correct(tiny):
    driver, run = tiny
    with driver.reference_in_place(run, cast=None):
        out = driver.run(run)
    assert out.correct, out.checks


def test_the_fp8_control_fails_the_check(tiny):
    driver, run = tiny
    with driver.reference_in_place(run):
        out = driver.run(run)
    assert not out.correct, out.checks
    assert _checks(out)["box_faults"] == 0 and _checks(out)["index_faults"] == 0


class _Nothing(torch.nn.Module):
    def forward(self, x):
        return 0


def test_a_dropped_fusion_path_is_caught(tiny, monkeypatch):
    from h36x_torch.extract import pipeline

    driver, run = tiny
    real = pipeline._load_backbone

    def short(cfg, device):
        model = real(cfg, device)
        model.stage4[-1].fuse_layers[0][1] = _Nothing()  # branch 1 into branch 0
        return model

    monkeypatch.setattr(pipeline, "_load_backbone", short)
    out = driver.run(run)
    assert not out.correct, out.checks


def test_a_traced_run_reports_what_the_cpu_can_read(tiny):
    driver, run = tiny
    run.trace = True
    out = driver.run(run)
    assert out.correct, out.checks
    rec = dict(out.record, trace={"busy_s": 0.0, "window_s": 1.0})
    # the CPU has no device events: the device readers find nothing
    assert harness.read_metric("mfu.hrnet", out.record) > 0  # host clock over flops
    for name in ("device_roofline.hrnet", "idle_share.hrnet", "branch_roofline.hrnet",
                 "fuse_roofline.hrnet"):
        assert harness.read_metric(name, rec) is None
    assert harness.read_metric("backbone_load_s.hrnet", rec) > 0
    assert out.record["traced_flops"] > 0
    assert 0 < out.record["fuse_bound_s"] < out.record["branch_bound_s"] \
        < out.record["traced_bound_s"]


def test_a_program_without_the_backbone_fails_before_set_up(tiny, monkeypatch):
    import h36x_torch.config as config

    driver, run = tiny
    monkeypatch.setattr(config, "BACKBONE_FEATURE_DIM", {"resnet50": 2048, "vit_h": 1280})
    with pytest.raises(RuntimeError, match="no --backbone hrnet_w48"):
        driver.run(run)
    assert not (run.workdir / "hrnet_w48.pt").exists()


def test_an_older_program_without_the_table_fails_before_set_up(tiny, monkeypatch):
    import h36x_torch.config as config

    driver, run = tiny

    @dataclasses.dataclass
    class Older:
        out: str = ""

    monkeypatch.delattr(config, "BACKBONE_FEATURE_DIM")
    monkeypatch.setattr(config, "ExtractConfig", Older)
    with pytest.raises(RuntimeError, match="no --backbone hrnet_w48"):
        driver.run(run)
    assert not (run.workdir / "hrnet_w48.pt").exists()


# ----------------------------------------------------------------- readers

def test_readers_on_a_hand_made_record():
    rec = {"traced_flops": 989e12 * 0.3, "traced_window_s": 1.0, "traced_bound_s": 0.2,
           "branch_bound_s": 0.05, "branch_device_s": 0.4, "fuse_bound_s": 0.01,
           "fuse_device_s": 0.08, "trace": {"busy_s": 0.8, "window_s": 1.0}}
    read = lambda name, rec: harness.read_metric(name, rec)  # noqa: E731
    assert read("mfu.hrnet", rec) == pytest.approx(30.0)
    assert read("device_roofline.hrnet", rec) == pytest.approx(25.0)
    assert read("idle_share.hrnet", rec) == pytest.approx(20.0)
    assert read("branch_roofline.hrnet", rec) == pytest.approx(12.5)
    assert read("fuse_roofline.hrnet", rec) == pytest.approx(12.5)
    for name in NEW:
        assert read(name, {}) is None
    assert read("branch_roofline.hrnet", dict(rec, branch_device_s=0.0)) is None
    assert read("fuse_roofline.hrnet", dict(rec, fuse_device_s=0.0)) is None
    assert read("fuse_roofline.hrnet", {k: v for k, v in rec.items() if k != "trace"}) is None


def test_the_new_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "from portbench import harness, roofline_hrnet\n"
            "import portbench.reference.hrnet_w48\n"
            "harness.load_module(harness.HERE / 'drivers' / 'extract_hrnet.py', 'd')\n"
            f"for m in {NEW!r}:\n"
            "    harness.load_module(harness.HERE / 'metrics' / f'{m}.py', m)\n"
            "import h36x_torch.models.hrnet\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.HERE.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    code = ("import sys\nimport portbench.reference.hrnet_w48\nimport tests.hrnet_reference\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('h36x_torch', 'h36x', 'jax', 'jaxlib', 'flax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.HERE.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
