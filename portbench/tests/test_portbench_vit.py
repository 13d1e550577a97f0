"""The ViTPose-H cell (vitpose_h.extract-256x192) on the CPU at a tiny
size: its entries, the roofline units against counts made by hand, the
benchmark's reference against the program, the cell's whole run sound and
with each fault it can have planted underneath (the check has to come out
false), the fp8 control, and every new reader on hand-made records and
traces, the span attribution through `correlation` ids included."""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, span_trace
from portbench import roofline as r
from portbench import roofline_vit as rv
from portbench.reference import vit_h as ref_vit
from portbench.tests.conftest import TINY_EXTRACT, bench

CELL = "vitpose_h.extract-256x192"
NEW = ("mfu.vit", "device_roofline.vit", "idle_share.vit", "attention_roofline.vit",
       "backbone_load_s.vit")
TINY_WIDTHS = dict(img_size=[32, 24], crop_size=32, patch_size=8, patch_padding=2,
                   embed_dim=64, depth=2, num_heads=4, mlp_dim=256,
                   # timm's 0.02 at ViT-H's width, scaled as 1 / sqrt(width)
                   init_std=0.02 * (1280 / 64) ** 0.5)
FULL = dict(img_size=(256, 192), patch=16, padding=2, dim=1280, depth=32, heads=16,
            mlp=5120, eps=1e-6)


def _driver():
    return harness.load_module(harness.HERE / "drivers" / "extract_vit.py",
                               "test_driver_extract_vit")


@pytest.fixture
def tiny(monkeypatch):
    """(driver, run) of the cell at a tiny size, the program's ViT-H at the
    same tiny widths."""
    from h36x_torch.models import vit

    cell = harness.Cell.from_file(CELL)
    cell.spec.update(TINY_EXTRACT, resize=32)
    cell.config.update(TINY_WIDTHS)
    monkeypatch.setattr(vit, "VIT_H", ref_vit.sizes(cell.config))
    run = harness.Run(cell, 2**33 + 5, 0.5, False, torch.device("cpu"), time.perf_counter(),
                      harness.Run.workdir_for(CELL))
    return _driver(), run


def _checks(out) -> dict:
    return {n: v for n, v, _ in out.checks}


# ---------------------------------------------------------------- entries

def test_the_cell_config_and_metrics_are_entries():
    b = bench()
    cell = harness.Cell.find(b, CELL)
    assert cell.chips == 1 and cell.spec["driver"] == "extract_vit"
    assert sorted(cell.e2e) == ["extract_clips_per_s", "setup_s"]
    assert sorted(cell.per_layer) == sorted(NEW)
    entries = {m["name"]: m for m in b["per_layer"]}
    for name in NEW:
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "extract_clips_per_s"
        assert (harness.HERE / "metrics" / f"{name}.py").is_file()
    assert ref_vit.sizes(cell.config) == FULL
    cfg = {c["name"]: c for c in b["configs"]}["vitpose_h"]
    assert cfg["reduced"] == ["decode", "videos_per_job"] == sorted(cell.config["reduced"])
    # the resnet cell keeps what it had
    assert harness.Cell.find(b, "resnet50.extract-opt").per_layer == [
        m["name"] for m in b["per_layer"] if "resnet50.extract-opt" in m.get("workloads", [])]


def test_the_configuration_holds_the_program_s_published_widths():
    from h36x_torch.models import vit

    cfg = harness.Cell.find(bench(), CELL).config
    assert ref_vit.sizes(cfg) == vit.VIT_H
    assert cfg["tokens"] == ref_vit.tokens(ref_vit.sizes(cfg)) == 192
    assert cfg["head_dim"] * cfg["num_heads"] == cfg["embed_dim"] == cfg["feature_dim"]
    import math

    assert cfg["parameters"] == sum(math.prod(s) for _, s, _ in
                                    ref_vit.param_specs(ref_vit.sizes(cfg)))


# ---------------------------------------------------------------- roofline

def test_units_by_hand_at_a_small_size():
    s = dict(img_size=(8, 4), patch=4, padding=0, dim=4, depth=1, heads=2, mlp=8, eps=1e-6)
    u = {x.name: x for x in rv.vit_units(3, s, act=2, w=2)}
    # 2 x 1 tokens a frame, 3 frames: 6 rows; patch K = 3 * 4 * 4 = 48
    assert u["embed"].flops == 2 * 6 * 4 * 48
    assert u["embed"].nbytes == 3 * 8 * 4 * 3 + (4 * 48 + 4 + 3 * 4) * 2 + 6 * 4 * 2
    # qkv 2*6*4*12, proj 2*6*4*4, q k^T and a v 2 * (2*3 frames*2 heads*2*2*2)
    assert u["block0.attention"].flops == 2 * 6 * 4 * 12 + 2 * 6 * 4 * 4 + 2 * 2 * 3 * 2 * 2 * 2 * 2
    assert u["block0.attention"].nbytes == 2 * 6 * 4 * 2 + (48 + 12 + 16 + 4 + 8) * 2
    assert u["block0.mlp"].flops == 2 * 2 * 6 * 4 * 8
    assert u["block0.mlp"].nbytes == 2 * 6 * 4 * 2 + (32 + 8 + 32 + 4 + 8) * 2
    assert u["head"].flops == 0 and u["head"].nbytes == 6 * 4 * 2 + 8 * 2 + 3 * 4 * 4
    assert [x.name for x in rv.attention_units(3, s)] == ["block0.attention"]


def test_published_widths_count_248_gflop_a_frame():
    units = rv.vit_units(1, FULL)
    per = {x.name: x.flops for x in units}
    t, d = 192, 1280
    assert per["embed"] == 2 * t * d * 768 == 377_487_360
    # qkv 1.89, q k^T and a v 0.19, proj 0.63 GFLOP
    assert per["block0.attention"] == 2 * t * d * 3 * d + 2 * 2 * 16 * t * t * 80 \
        + 2 * t * d * d == 2_705_326_080
    assert per["block0.mlp"] == 2 * 2 * t * d * 5120 == 5_033_164_800
    assert r.total_flops(units) == 248_009_195_520  # 248 GFLOP a frame
    assert len(units) == 2 + 2 * 32
    # a dispatch of 3,840 frames is bound by operations, unit by unit
    for x in rv.vit_units(3840, FULL):
        assert x.flops / r.PEAK_FLOPS >= x.nbytes / r.PEAK_BYTES or x.flops == 0
    flops, bound = r.over_batches(lambda n: rv.vit_units(n, FULL), r.batch_sizes(6000, 3840))
    assert flops == pytest.approx(6000 * 248.0e9, rel=1e-3)


# --------------------------------------------------------------- reference

def test_the_benchmark_reference_matches_the_program_at_a_tiny_size():
    from h36x_torch.models import vit

    s = ref_vit.sizes(dict(TINY_WIDTHS, layer_norm_eps=1e-6))
    w = ref_vit.make_weights(s, torch.Generator().manual_seed(7), "cpu",
                             std=TINY_WIDTHS["init_std"])
    x = torch.randint(0, 256, (9, 32, 32, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(8))
    want = ref_vit.forward(w, x, s).double()
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        model = vit.load_vitpose(vit.ViT(dtype=dtype, **s), w, "cpu")
        with torch.inference_mode():
            got = model(x).double()
        assert float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max()) <= tol
    # the fp8 control's arithmetic moves it far more than bfloat16
    low = ref_vit.forward(w, x, s, cast=__import__(
        "portbench.reference.lower", fromlist=["fp8_cast"]).fp8_cast).double()
    assert float(((low - want).norm(dim=-1) / want.norm(dim=-1)).max()) > 2e-2


def test_the_tests_reference_and_the_benchmark_s_agree():
    from tests import vit_reference as tests_ref

    s = ref_vit.sizes(dict(TINY_WIDTHS, layer_norm_eps=1e-6))
    w = ref_vit.make_weights(s, torch.Generator().manual_seed(7), "cpu", std=0.05)
    w2 = tests_ref.make_weights(s, torch.Generator().manual_seed(7), std=0.05)
    assert all(torch.equal(w[k], w2[k]) for k in w) and w.keys() == w2.keys()
    x = torch.randint(0, 256, (3, 32, 32, 3), dtype=torch.uint8)
    torch.testing.assert_close(ref_vit.forward(w, x, s), tests_ref.forward(w2, x, s))


# ------------------------------------------------------------- whole runs

def test_sound_run_is_correct(tiny):
    driver, run = tiny
    out = driver.run(run)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    # every dispatch is padded to one shape: its tokens count the padding too
    assert out.proof["vit_tokens"] >= out.proof["backbone_frames"] * 12 > 0
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


def test_an_unscaled_softmax_is_caught(tiny, monkeypatch):
    import torch.nn.functional as F

    driver, run = tiny
    real = F.scaled_dot_product_attention
    monkeypatch.setattr(F, "scaled_dot_product_attention",
                        lambda q, k, v, **kw: real(q, k, v, scale=1.0))
    out = driver.run(run)
    assert not out.correct, out.checks


def test_a_skipped_block_is_caught(tiny, monkeypatch):
    from h36x_torch.extract import pipeline

    driver, run = tiny
    real = pipeline._load_backbone

    def short(cfg, device):
        model = real(cfg, device)
        model.blocks = model.blocks[:-1]
        return model

    monkeypatch.setattr(pipeline, "_load_backbone", short)
    out = driver.run(run)
    assert not out.correct, out.checks


def test_columns_not_sliced_from_the_middle_are_caught(tiny, monkeypatch):
    from h36x_torch.models import vit

    driver, run = tiny
    monkeypatch.setattr(vit.ViT, "columns", lambda self, side: slice(0, self.img_size[1]))
    out = driver.run(run)
    assert not out.correct, out.checks


def test_a_traced_run_reports_what_the_cpu_can_read(tiny):
    driver, run = tiny
    run.trace = True
    out = driver.run(run)
    assert out.correct, out.checks
    rec = dict(out.record, trace={"busy_s": 0.0, "window_s": 1.0})
    # the CPU has no device events: the device readers find nothing
    for name in ("mfu.vit", "device_roofline.vit", "idle_share.vit",
                 "attention_roofline.vit"):
        if name == "mfu.vit":
            assert harness.read_metric(name, out.record) > 0  # host clock over flops
        else:
            assert harness.read_metric(name, rec) is None
    assert harness.read_metric("backbone_load_s.vit", rec) > 0
    assert out.record["traced_flops"] > 0 and out.record["attention_bound_s"] > 0


def test_a_program_without_the_backbone_fails_before_set_up(tiny, monkeypatch):
    import h36x_torch.config as config

    driver, run = tiny

    @dataclasses.dataclass
    class Older:
        out: str = ""

    monkeypatch.setattr(config, "ExtractConfig", Older)
    with pytest.raises(RuntimeError, match="no --backbone"):
        driver.run(run)
    assert not (run.workdir / "vit_h.pt").exists()


# ----------------------------------------------------------------- readers

def test_readers_on_a_hand_made_record():
    rec = {"traced_flops": 989e12 * 0.4, "traced_window_s": 1.0, "traced_bound_s": 0.3,
           "attention_bound_s": 0.05, "attention_device_s": 0.2,
           "trace": {"busy_s": 0.6, "window_s": 1.0}}
    read = lambda name, rec: harness.read_metric(name, rec)  # noqa: E731
    assert read("mfu.vit", rec) == pytest.approx(40.0)
    assert read("device_roofline.vit", rec) == pytest.approx(50.0)
    assert read("idle_share.vit", rec) == pytest.approx(40.0)
    assert read("attention_roofline.vit", rec) == pytest.approx(25.0)
    for name in NEW:
        assert read(name, {}) is None
    assert read("attention_roofline.vit", dict(rec, attention_device_s=0.0)) is None


def test_backbone_load_reader_reads_the_program_s_span(monkeypatch):
    from collections import defaultdict

    from h36x_torch.utils import profiling
    from h36x_torch.utils.timers import PhaseTimers

    monkeypatch.setattr(profiling, "_TABLE", PhaseTimers())
    monkeypatch.setattr(profiling, "_CALLS", defaultdict(list))
    traced = {"trace": {"busy_s": 1.0, "window_s": 2.0}}
    assert harness.read_metric("backbone_load_s.vit", traced) is None
    profiling._TABLE.add("h36x.extract.load_backbone", 3.0)
    profiling._TABLE.add("h36x.extract.load_backbone", 1.0)
    assert harness.read_metric("backbone_load_s.vit", traced) == pytest.approx(2.0)
    assert harness.read_metric("backbone_load_s.vit", {}) is None


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_device_time_goes_to_the_innermost_span_holding_the_launch():
    events = [
        _x("h36x.extract.feature_fn", "user_annotation", 0, 1000),
        _x("h36x.vit.attention", "user_annotation", 100, 100),
        _x("h36x.vit.mlp", "user_annotation", 300, 100),
        _x("h36x.vit.head", "user_annotation", 500, 50),
        _x("h36x.vit.embed", "user_annotation", 105, 10),  # nested: innermost wins
        _x("cudaLaunchKernel", "cuda_runtime", 110, 2, corr=1),  # embed
        _x("cudaLaunchKernel", "cuda_runtime", 150, 2, corr=2),  # attention
        _x("cuLaunchKernelEx", "cuda_driver", 190, 2, corr=3),   # attention
        _x("cudaLaunchKernel", "cuda_runtime", 350, 2, corr=4),  # mlp
        _x("cudaLaunchKernel", "cuda_runtime", 450, 2, corr=5),  # outside every vit span
        _x("cudaLaunchKernel", "cuda_runtime", 150, 2, tid=2, corr=6),  # other thread
        _x("cudaMemcpyAsync", "cuda_runtime", 520, 2, corr=7),  # head
        _x("k1", "kernel", 2000, 7, tid=7, corr=1),
        _x("k2", "kernel", 2010, 30, tid=7, corr=2),
        _x("k3", "kernel", 2050, 20, tid=7, corr=3),
        _x("k4", "kernel", 2080, 40, tid=7, corr=4),
        _x("k5", "kernel", 2130, 5, tid=7, corr=5),
        _x("k6", "kernel", 2140, 5, tid=7, corr=6),
        _x("copy", "gpu_memcpy", 2150, 3, tid=7, corr=7),
        _x("orphan", "kernel", 2160, 9, tid=7, corr=99),
        _x("h36x.vit.attention", "gpu_user_annotation", 2010, 60, tid=7),
    ]
    got = span_trace.device_s_by_span(events, "h36x.vit.")
    assert got == pytest.approx({"h36x.vit.embed": 7e-6, "h36x.vit.attention": 50e-6,
                                 "h36x.vit.mlp": 40e-6, "h36x.vit.head": 3e-6})


def test_a_span_trace_on_the_cpu_holds_no_device_time(tmp_path):
    from h36x_torch.utils.profiling import span

    tr = span_trace.SpanTrace(tmp_path / "t.json", False, "h36x.vit.")
    with tr:
        with span("h36x.vit.attention"):
            torch.ones(4) @ torch.ones(4)
    assert tr.finish() is None and tr.device_s == {}
    assert not (tmp_path / "t.json").exists()


def test_the_new_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "from portbench import harness, roofline_vit, span_trace\n"
            "import portbench.reference.vit_h\n"
            "harness.load_module(harness.HERE / 'drivers' / 'extract_vit.py', 'd')\n"
            "for m in ('mfu.vit', 'device_roofline.vit', 'idle_share.vit',\n"
            "          'attention_roofline.vit', 'backbone_load_s.vit'):\n"
            "    harness.load_module(harness.HERE / 'metrics' / f'{m}.py', m)\n"
            "import h36x_torch.models.vit\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.HERE.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    code = ("import sys\nimport portbench.reference.vit_h\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('h36x_torch', 'h36x', 'jax', 'jaxlib', 'flax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.HERE.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
