"""The readings that the correctness limits are set from, on the card, at
each cell's own size, in one process:

    python3 -m portbench.controls --workload NAME --seeds S1 S2 ... \
        [--control-seeds C1 C2 ...] [--faults] [--seconds 3] [--out FILE]

- for each of --seeds, the program's readings: the cell's checks after a
  short run (training: set-up and one epoch; serving: --seconds of its
  load; extraction: set-up and one call);
- for each of --control-seeds, the control's: the cell's whole run with
  the plain reference put in the program's place, one precision below the
  configuration's, judged by the driver's own comparison (training, float32:
  the reference's forward and backward in TF32 in place of the step's
  gradients, the program's AdamW applying them; serving, bf16 weights and
  activations: the reference with fp8 e4m3 operands as the daemon's predict
  function; extraction, bfloat16: the reference with fp8 e4m3 operands as
  the backbone's feature function);
- with --faults, for each control seed, a training cell's planted fault:
  half of each batch left out, the loss's mean taken over the rest. (A
  step that leaves its state unchanged reads 1 on the change by the
  measure itself and needs no run.)

It prints one JSON line per reading and writes them all to --out. The
benchmark's own runs never run it; portbench/tests/test_portbench_controls.py
keeps it at a size a test run holds.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import harness, rules, synth
from portbench.reference import phd as ref_phd
from portbench.reference import resnet50 as ref_resnet
from portbench.reference.lower import fp8_cast


def program(cell, driver, seed, seconds, device) -> dict:
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False, device=device,
                      t_start=time.perf_counter(), workdir=harness.Run.workdir_for(cell.name))
    with contextlib.redirect_stdout(sys.stderr):
        out = driver.run(run)
    return {name: v for name, v, _ in out.checks}


def control(cell, driver, seed, seconds, device) -> harness.Outcome:
    """The cell's run with the lower-precision reference in the program's
    place: its outcome, which has to come out not correct."""
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False, device=device,
                      t_start=time.perf_counter(), workdir=harness.Run.workdir_for(cell.name))
    lower = {"train": dict(tf32=True), "extract": dict(cast=fp8_cast),
             "serve": dict(cast=fp8_cast)}[cell.spec["driver"]]
    with reference_in_place(driver, run, **lower), contextlib.redirect_stdout(sys.stderr):
        return driver.run(run)


@contextlib.contextmanager
def reference_in_place(driver, run, cast=None, tf32=False):
    """The plain reference in the program's place for the cell's driver:
    its operands rounded by `cast`, its matrix products in TF32 with
    `tf32`. Without either, a sound run."""
    kind, cfg = run.cell.spec["driver"], run.cell.config
    if kind == "train":
        from h36x_torch.train import step

        def reference_grads(model, batch, generator=None, **kw):
            params = dict(model.named_parameters())
            w = {n: p.detach() for n, p in params.items()}
            names = ref_phd.trainable(cfg)
            keep = 1.0 - cfg["dropout"]
            dev = batch[0].device
            mask = ((lambda shape: rules.dropout_mask(shape, keep, generator, dev))
                    if keep < 1.0 else None)
            loss, grads = ref_phd.loss_and_grads(w, names, batch[0].float(), batch[1], cfg,
                                                 mask)
            model.zero_grad(set_to_none=True)
            for n in names:
                params[n].grad = grads[n]
            zero = torch.zeros_like(loss)
            return {"loss": loss, "l3d": loss, "l2d": zero, "mpjpe": zero, "bone": zero}

        tf32_was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            with _patched(step, "grads_and_metrics", reference_grads):
                yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32_was
    elif kind == "extract":
        from h36x_torch.extract import pipeline

        w = ref_resnet.make_weights(synth.generator(run.seed, "resnet50", device=run.device),
                                    run.device)

        def reference_feature_fn(model, mesh=None, engine=None):
            def features(frames_u8):
                x = torch.as_tensor(frames_u8).to(run.device)
                with torch.no_grad():
                    return torch.cat([ref_resnet.forward(w, rules.normalize(x[i:i + BLOCK]),
                                                         cast)
                                      for i in range(0, len(x), BLOCK)])
            return features

        with _patched(pipeline, "make_feature_fn", reference_feature_fn):
            yield
    elif kind == "serve":
        def reference_predict(run, ckpt):
            w = synth.phd_weights(cfg, run.seed, run.device)

            def predict(feats):
                x = torch.from_numpy(np.ascontiguousarray(feats)).to(run.device)
                with torch.no_grad():
                    return ref_phd.forward(w, x, cfg, cast=cast).cpu().numpy()
            return predict

        with _patched(driver, "make_predict", reference_predict):
            yield
    else:
        raise ValueError(f"no control for driver {kind!r}")


BLOCK = 125  # frames a reference call


@contextlib.contextmanager
def _patched(obj, attr, value):
    real = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, real)


@contextlib.contextmanager
def half_batch():
    """The training step's gradients and loss from the first half of each
    batch alone."""
    from h36x_torch.train import step

    real = step.grads_and_metrics

    def half(model, batch, generator=None, **kw):
        keep = batch[0].shape[0] // 2
        return real(model, tuple(b[:keep] for b in batch), generator, **kw)

    with _patched(step, "grads_and_metrics", half):
        yield


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", action="store_true")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls: the readings are the card's; CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell.from_file(args.workload)
    driver = harness.load_module(harness.HERE / "drivers" / f"{cell.spec['driver']}.py",
                                 "portbench_controls_driver")
    dev = torch.device("cuda", 0)
    rows = []

    def emit(kind, seed, readings):
        row = {"workload": cell.name, "kind": kind, "seed": seed, **readings}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        emit("program", seed, program(cell, driver, seed, args.seconds, dev))
    for seed in args.control_seeds:
        out = control(cell, driver, seed, args.seconds, dev)
        emit("control", seed, {**{n: v for n, v, _ in out.checks}, "correct": out.correct})
        if args.faults:
            with half_batch():
                emit("half_batch", seed, program(cell, driver, seed, args.seconds, dev))
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
