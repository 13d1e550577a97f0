"""Build and load the hand-written CUDA kernels (nvcc -> shared library ->
ctypes).

Each source under `csrc/` exports plain C entry points that take device
pointers, sizes and a CUDA stream, launch on that stream and return
`cudaGetLastError()`. At first use a source is compiled for Hopper
(`sm_90a`; sources asked for together compile in parallel) into `build/h36x_torch/` at the repository root, under a name
keyed by a hash of the source and the flags, and moved into place by an
atomic rename, so a concurrent build never loads a half-written library
and a changed source never loads a stale one. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "h36x_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source name -> {C symbol: argtypes}; every symbol returns cudaError_t (int)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "temporal": {
        # x, scale, bias, w, cb, res|NULL, mean, rstd, out,
        # B, T, D, O, K, G, eps, stream
        "h36x_gn_relu_cconv": [_P] * 9 + [_I] * 6 + [_F, _P],
    },
    "regressor": {
        # phi, w1, b1, w2, b2, w3, b3, out, N, D, H, out_dim, iters, stream
        "h36x_joint_regressor": [_P] * 8 + [_I] * 5 + [_P],
    },
}

_lock = threading.Lock()
_libs: dict = {}
build_seconds: dict = {}  # source name -> wall seconds of its nvcc run
build_logs: dict = {}  # source name -> nvcc output (ptxas register report)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc" if cand else None
        if path is not None and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels of "
                           "h36x_torch are built on the machine with the card")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def _start_build(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish_build(name: str, job) -> None:
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def load(*names: str) -> list:
    """The loaded library of each csrc/<name>.cu, in order, with every entry
    point's argtypes declared (pointers and the stream as c_void_p: an
    undeclared argument would be passed as a 32-bit int). Sources not built
    yet are compiled first, one nvcc process each, all started together."""
    with _lock:
        missing = [n for n in dict.fromkeys(names) if n not in _libs]
        jobs = {n: _start_build(n) for n in missing}
        for n, job in jobs.items():
            if job is not None:
                _finish_build(n, job)
        for n in missing:
            lib = ctypes.CDLL(str(_lib_path(n)))
            for sym, argtypes in SIGNATURES[n].items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[n] = lib
        return [_libs[n] for n in names]


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error (a launch refused
    for its shared memory or thread count never runs, and a later
    synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def require_cuda_f32(what: str, **tensors) -> None:
    """The kernels take contiguous float32 CUDA tensors on one device, and
    have no backward yet: a tensor that needs a gradient is refused rather
    than silently cut from the graph."""
    device = None
    for name, t in tensors.items():
        if t is None:
            continue
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{what}: {name} requires grad, but the kernel "
                               "has no backward; run it under torch.no_grad()")
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, expected cuda")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, others on {device}")
