"""Run one cell of the benchmark of h36x_torch and print its result line.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell's driver builds the program's
objects from the seed (set-up), runs them for S seconds (the window),
checks what the window produced against the plain reference and hands back
its numbers. With --trace 0 the result carries the cell's end-to-end
metrics, with --trace 1 its per-layer metrics, read from a torch.profiler
trace of the window's first unit (a serving cell's whole window) and from
the driver's counters. The last line
of standard output is the result, one JSON object; the numbers compared,
each beside its limit, end standard error.

It exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, outside a checkout that holds the program, and
when JAX or the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

CPU_THREADS = 4


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell: harness.Cell, out: harness.Outcome, trace: bool, device: dict) -> dict:
    units = cell.units
    if trace:
        rec = dict(out.record, trace=out.trace)
        metrics = {}
        for name in cell.per_layer:
            value = harness.read_metric(name, rec)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        metrics = {name: {"value": out.e2e[name] if name != "setup_s" else out.setup_s,
                          "unit": units[name]} for name in cell.e2e}
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if trace and out.trace is not None:
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    return line


def execute(cell: harness.Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set-up, window and check of `cell` on `device`: the result line, or
    SystemExit where JAX or the JAX package was loaded."""
    import torch

    driver = harness.load_module(harness.HERE / "drivers" / f"{cell.spec['driver']}.py",
                                 f"portbench_driver_{cell.spec['driver']}")
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device,
                      t_start=T_START, workdir=harness.Run.workdir_for(cell.name))
    try:
        # the program's prints go to standard error: the result ends stdout
        with contextlib.redirect_stdout(sys.stderr):
            out = driver.run(run)
    finally:
        shutil.rmtree(run.workdir, ignore_errors=True)
    bad = harness.forbidden_modules()
    if bad:
        fail(f"JAX or the JAX package was loaded: {', '.join(bad)}", 3)
    cuda = device.type == "cuda"
    info = {"platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else device.type,
            "count": cell.chips, "memory_peak_bytes": int(out.memory_peak_bytes),
            "power_limit": _power_limit() if cuda else None}
    if trace:
        if out.trace is None:
            fail("the traced window holds no device operation")
        info["busy_s"] = out.trace["busy_s"]
        info["window_s"] = out.trace["window_s"]
    print("proof of path: " + json.dumps(out.proof), file=sys.stderr)
    line = result_line(cell, out, trace, info)
    for name, v, lim in out.checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    return line


def main(argv=None) -> int:
    args = parse(argv)
    bench_path = Path.cwd() / "BENCHMARK.json"
    if not bench_path.is_file():
        fail(f"no BENCHMARK.json in {Path.cwd()}: run from the root of a checkout")
    bench = harness.load_json(bench_path)
    cell = harness.Cell.find(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: the benchmark measures the card")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} asks for {cell.chips} cards; "
             f"{torch.cuda.device_count()} visible")
    try:
        import h36x_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program is not in this checkout ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a fixed number of the host's threads for PyTorch's own CPU work,
    # whatever the machine has: idle ones spin against the loop's threads
    torch.set_num_threads(CPU_THREADS)
    line = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    print(json.dumps(line), flush=True)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
