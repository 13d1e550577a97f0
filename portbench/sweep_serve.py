"""The one-time knee sweep of a serving cell: its traffic at a list of
offered rates, each a short run of the cell's driver in this process, on
the card.

    python3 -m portbench.sweep_serve --workload phd.serve-poisson \
        --rates 500 1000 2000 --seconds 8 --seed 1 [--out sweep.json]

For each rate it prints the requests offered, the share answered, the
daemon's refusals, the requests lost, p50 / p95 / p99 latency, the median
latency of the first and the last fifth of the requests (a backlog that
grows shows as the last above the first) and how late the generator sent.
The knee is the highest rate at which, and at every rate below which, at
least 99 % of the offered requests are answered, none is refused or lost
and the last fifth's median stays within twice the first's; the cell's
file takes 0.8 x the knee as its rate.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    import torch

    from portbench import harness

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", default="phd.serve-poisson")
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_serve: the sweep measures the card; CUDA is not available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.Cell.from_file(args.workload)
    driver = harness.load_module(harness.HERE / "drivers" / f"{cell.spec['driver']}.py",
                                 "portbench_sweep_driver")
    rows, knee, failed = [], None, False
    for i, rate in enumerate(sorted(args.rates)):
        cell.spec["rate"] = rate
        run = harness.Run(cell=cell, seed=args.seed + i, seconds=args.seconds, trace=False,
                          device=torch.device("cuda", 0), t_start=time.perf_counter(),
                          workdir=harness.Run.workdir_for(cell.name))
        with contextlib.redirect_stdout(sys.stderr):
            out = driver.run(run)
        pr = out.proof
        row = {"rate": rate, "offered": pr["requests"],
               "answered_share": pr["answered"] / pr["requests"],
               "refused": sum(pr["errors"].values()), "lost": pr["lost"],
               "p50_ms": pr["p50_ms"], "p95_ms": out.e2e["serve_p95_ms"],
               "first_fifth_p50_ms": pr["p50_ms_first_fifth"],
               "last_fifth_p50_ms": pr["p50_ms_last_fifth"],
               "generator_late_ms": pr["generator_late_ms"],
               "rows_per_batch": pr["rows"] / max(1, pr["batches"]),
               "correct": out.correct}
        rows.append(row)
        print(json.dumps(row), flush=True)
        ok = (row["answered_share"] >= 0.99 and row["refused"] == 0 and row["lost"] == 0
              and row["last_fifth_p50_ms"] is not None
              and row["last_fifth_p50_ms"] <= 2 * row["first_fifth_p50_ms"])
        failed = failed or not ok
        if not failed:
            knee = rate
    result = {"workload": cell.name, "seconds": args.seconds, "rows": rows, "knee": knee,
              "rate_at_0.8": None if knee is None else float(np.round(0.8 * knee, 1)),
              "device": torch.cuda.get_device_name(0)}
    print(json.dumps({"knee": knee, "rate_at_0.8": result["rate_at_0.8"]}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
