"""h36x_torch stands alone: importing every port module pulls in none of
jax, flax, msgpack, ml_dtypes or h36x (nor OpenCV, h5py or spacepy, which
the port imports only inside the functions that need them), and no port
source (nor chip_smoke.py) names them in an import. The import checks run
in subprocesses, since this test process already holds jax
(tests/conftest.py imports it)."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "ml_dtypes", "h36x")
LAZY = ("cv2", "h5py", "spacepy")  # imported inside functions only
PORT_FILES = sorted((ROOT / "h36x_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    pkg = ROOT / "h36x_torch"
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py"))


def test_importing_the_port_loads_no_jax_flax_msgpack_or_h36x():
    """...nor OpenCV, h5py or spacepy, which the port imports only inside
    the functions that need them (the machine with the card has none)."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN + LAZY]
    assert not bad, bad
    for m in ("h36x_torch.serve_daemon", "h36x_torch.cli.extract",
              "h36x_torch.extract.pipeline", "h36x_torch.extract.dedup",
              "h36x_torch.models.resnet", "h36x_torch.ops.bottleneck",
              "h36x_torch.native", "h36x_torch.serve", "h36x_torch.cli.predict",
              "h36x_torch.cli.results", "h36x_torch.cli.debug_batch",
              "h36x_torch.train.results", "h36x_torch.ops.matmul_probe",
              "h36x_torch.benchmarks.int8_kernel_probe", "h36x_torch.export",
              "h36x_torch.cli.export", "h36x_torch.data.ingest", "h36x_torch.data.masks",
              "h36x_torch.cli.ingest", "h36x_torch.cli.merge_shards",
              "h36x_torch.ops.preprocess", "h36x_torch.ops.resize",
              "h36x_torch.parallel.distributed", "h36x_torch.parallel.mesh"):
        assert m in loaded, m


NEW_MODULES = ("h36x_torch.data.ingest", "h36x_torch.data.masks", "h36x_torch.cli.ingest",
               "h36x_torch.data.shards", "h36x_torch.cli.merge_shards",
               "h36x_torch.ops.preprocess", "h36x_torch.ops.resize",
               "h36x_torch.parallel.distributed", "h36x_torch.parallel.mesh",
               "h36x_torch.cli.train")


def test_new_modules_import_where_cv2_h5py_spacepy_and_ml_dtypes_are_missing():
    """Each of this slice's modules imports with cv2, h5py, spacepy and
    ml_dtypes made unimportable (as on the machine with the card), and
    ingest's pose reader still reads an npz there."""
    code = (
        "import sys, importlib, tempfile, os, numpy as np\n"
        f"for m in {LAZY + ('ml_dtypes',)!r}: sys.modules[m] = None\n"
        f"for m in {NEW_MODULES!r}: importlib.import_module(m)\n"
        "from h36x_torch.data.ingest import read_poses\n"
        "d = tempfile.mkdtemp(); p = os.path.join(d, 'x.npz')\n"
        "np.savez(p, Pose=np.zeros((1, 3, 64), np.float32))\n"
        "assert read_poses(p[:-4] + '.cdf').shape == (3, 17, 2)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
