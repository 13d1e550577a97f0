"""Each cell's whole run on the CPU at a tiny size (the look for a card
skipped), sound and with the timed path broken underneath: the check has
to come out false for every fault the cell can have. And the controls at
a size a test run holds."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import controls, harness
from portbench.controls import _patched
from portbench.tests.conftest import tiny_cell


def _run(name, seed=2**33 + 3, seconds=0.5, device="cpu"):
    cell = tiny_cell(name)
    driver = harness.load_module(harness.HERE / "drivers" / f"{cell.spec['driver']}.py",
                                 f"test_driver_{cell.spec['driver']}")
    run = harness.Run(cell, seed, seconds, False, torch.device(device), time.perf_counter(),
                      harness.Run.workdir_for(name))
    return driver, run


@pytest.mark.parametrize("name", ["phd.train-fused", "phd.train-plain",
                                  "phd.serve-poisson", "resnet50.extract-opt"])
def test_sound_run_is_correct(name):
    driver, run = _run(name)
    out = driver.run(run)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0


@pytest.mark.parametrize("name", ["phd.train-fused", "phd.train-plain"])
def test_a_step_that_leaves_its_state_unchanged_is_caught(name):
    from h36x_torch.train import state

    driver, run = _run(name)
    with _patched(state.AdamW, "step", lambda self, closure=None: None):
        out = driver.run(run)
    assert not out.correct
    assert dict((k, v) for k, v, _ in out.checks)["change_norm_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["phd.train-fused", "phd.train-plain"])
def test_half_of_the_batch_left_out_is_caught(name):
    driver, run = _run(name)
    with controls.half_batch():
        out = driver.run(run)
    assert not out.correct, out.checks


def test_an_answer_altered_where_it_is_produced_is_caught_in_serving():
    driver, run = _run("phd.serve-poisson")
    real = driver.make_predict

    def altered(run, ckpt):
        predict, calls = real(run, ckpt), [0]

        def wrong(feats):
            out = predict(feats)
            calls[0] += 1
            if calls[0] == 40:  # one reply of one batch, inside the window
                out = out.copy()
                out[0] *= 1.05
            return out
        return wrong

    with _patched(driver, "make_predict", altered):
        out = driver.run(run)
    assert not out.correct, out.checks


def test_an_answer_altered_where_it_is_produced_is_caught_in_extraction():
    from h36x_torch.extract import pipeline

    driver, run = _run("resnet50.extract-opt")
    real = pipeline.DeviceFeatures.numpy
    calls = [0]

    def altered(self, np_dtype):
        out = real(self, np_dtype)
        calls[0] += 1
        if calls[0] == 3:  # one feature row of the window's call
            out = out.copy()
            out[0] *= 1.05
        return out

    with _patched(pipeline.DeviceFeatures, "numpy", altered):
        out = driver.run(run)
    assert not out.correct, out.checks


@pytest.mark.parametrize("name", ["phd.train-fused", "phd.serve-poisson",
                                  "resnet50.extract-opt"])
def test_the_reference_in_the_programs_place_is_correct(name):
    # the control's wiring: at the configuration's own precision it passes
    driver, run = _run(name)
    with controls.reference_in_place(driver, run):
        out = driver.run(run)
    assert out.correct, out.checks


def test_the_training_reference_stays_float32_under_a_tf32_control():
    # the control turns TF32 on around the whole run, the check included
    from portbench.reference import phd as ref_phd

    driver, run = _run("phd.train-fused")
    seen, real = [], ref_phd.loss_and_grads

    def spy(*a, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*a, **kw)

    with controls.reference_in_place(driver, run, tf32=True), \
            _patched(ref_phd, "loss_and_grads", spy):
        out = driver.run(run)
        assert torch.backends.cuda.matmul.allow_tf32
    assert True in seen and seen[-3:] == [False] * 3, seen
    assert out.correct, out.checks  # on the CPU TF32 changes nothing


@pytest.mark.parametrize("name", ["phd.serve-poisson", "resnet50.extract-opt"])
def test_controls_in_fp8_fail_the_check(name):
    cell = tiny_cell(name)
    driver = harness.load_module(harness.HERE / "drivers" / f"{cell.spec['driver']}.py",
                                 f"test_control_{cell.spec['driver']}")
    out = controls.control(cell, driver, 5, 0.5, torch.device("cpu"))
    assert not out.correct, out.checks


@pytest.mark.cuda
def test_training_control_in_tf32_fails_the_check(cuda_device):
    cell = tiny_cell("phd.train-fused")
    cell.config.update(feature_dim=256, latent_dim=256, regressor_hidden=256, groups=32)
    driver = harness.load_module(harness.HERE / "drivers" / "train.py", "test_train_control")
    out = controls.control(cell, driver, 5, 0.0, cuda_device)
    assert not out.correct, out.checks


def test_half_of_a_serving_batch_left_out_is_caught():
    driver, run = _run("phd.serve-poisson")
    real = driver.make_predict

    def halved(run, ckpt):
        predict = real(run, ckpt)

        def half(feats):
            n = feats.shape[0]
            if n < 2:
                return predict(feats)
            out = predict(feats[: n // 2])
            return np.concatenate([out, out[: n - n // 2]])
        return half

    with _patched(driver, "make_predict", halved):
        out = driver.run(run)
    assert not out.correct, out.checks


def test_half_of_an_extraction_dispatch_left_out_is_caught():
    from h36x_torch.extract import pipeline

    driver, run = _run("resnet50.extract-opt")
    real = pipeline.DeviceFeatures.numpy

    def halved(self, np_dtype):
        out = real(self, np_dtype).copy()
        n = out.shape[0]
        out[n // 2:] = out[: n - n // 2]
        return out

    with _patched(pipeline.DeviceFeatures, "numpy", halved):
        out = driver.run(run)
    assert not out.correct, out.checks
