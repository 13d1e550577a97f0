"""What every driver shares: the run's context, the outcome it hands back,
and finding a cell's files by the names in BENCHMARK.json.

    portbench/configs/<config>.json      a configuration's sizes
    portbench/workloads/<cell>.json      a cell's driver and traffic
    portbench/drivers/<driver>.py        run(ctx) -> Outcome
    portbench/metrics/<metric>.py        read(record) -> float | None
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "h36x")  # top-level module names


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not Path(path).is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (`h36x_torch` is not `h36x`)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


@dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads with its files read."""
    name: str
    chips: int
    config_name: str
    config: dict
    spec: dict
    e2e: list  # the end-to-end metric names this cell reports
    per_layer: list  # the per-layer metric names this cell reports
    units: dict = field(default_factory=dict)  # metric name -> unit

    @classmethod
    def find(cls, bench: dict, name: str, root: Path = HERE) -> "Cell":
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(entries)})")
        w = entries[name]
        cfgs = {c["name"]: c for c in bench["configs"]}
        config = load_json(root.parent / cfgs[w["config"]]["file"])
        spec = load_json(root / "workloads" / f"{name}.json")
        e2e = [m["name"] for m in bench["end_to_end"]
               if name in m.get("workloads", [name])]
        per_layer = [m["name"] for m in bench["per_layer"]
                     if name in m.get("workloads", [name] if m["moves"] in e2e else [])]
        units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
        return cls(name, int(w["chips"]), w["config"], config, spec, e2e, per_layer, units)

    @classmethod
    def from_file(cls, name: str, root: Path = HERE) -> "Cell":
        """The cell of portbench/workloads/<name>.json on one chip, listed in
        BENCHMARK.json or not, without its metrics (for the sweep, the
        controls and the tests)."""
        spec = load_json(root / "workloads" / f"{name}.json")
        config = load_json(root / "configs" / f"{spec['config']}.json")
        return cls(name, 1, spec["config"], config, spec, [], [])


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t_start: float  # perf_counter at the process's start
    workdir: Path

    @staticmethod
    def workdir_for(cell: str) -> Path:
        """A fixed directory of the cell under TMPDIR, emptied first."""
        path = Path(tempfile.gettempdir()) / "portbench" / cell
        shutil.rmtree(path, ignore_errors=True)
        path.mkdir(parents=True)
        return path


@dataclass
class Outcome:
    setup_s: float
    e2e: dict  # end-to-end metric name -> value
    record: dict  # what the per-layer readers read
    attempted: int
    failed: int
    checks: list  # [(name, value, limit)]: correct when every value <= limit
    memory_peak_bytes: int = 0
    trace: Optional[dict] = None  # trace.summarize's
    proof: dict = field(default_factory=dict)  # counters printed as proof of path

    @property
    def correct(self) -> bool:
        return all(v is not None and v == v and v <= lim for _, v, lim in self.checks)


def read_metric(name: str, record: dict, root: Path = HERE) -> Optional[float]:
    """The per-layer metric `name`, read by portbench/metrics/<name>.py."""
    mod = load_module(root / "metrics" / f"{name}.py", f"portbench_metric_{name}")
    return mod.read(record)
