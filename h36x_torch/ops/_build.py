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

import contextlib
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
# but those listed in RESTYPES
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "temporal": {
        # x, scale, bias, w, cb, res|NULL, mean, rstd, out,
        # B, T, D, O, K, G, eps, rows between samples of x and of res, stream
        "h36x_gn_relu_cconv": [_P] * 9 + [_I] * 6 + [_F, _I, _I, _P],
        # B, T, D, O, K -> workspace bytes of the fast route (0: not taken)
        "h36x_gn_relu_cconv_fast_workspace": [_I] * 5,
        # x, scale, bias, w_bf16, cb, res|NULL, mean, rstd, ws, out,
        # B, T, D, O, K, G, eps, rows between samples of x and of res, stream
        "h36x_gn_relu_cconv_fast": [_P] * 10 + [_I] * 6 + [_F, _I, _I, _P],
    },
    "temporal_bwd": {
        # x, scale, bias, w, g, mean, rstd, da, part, dx, dw, dscale, dbias,
        # B, T, D, O, K, G, stream
        "h36x_gn_relu_cconv_bwd": [_P] * 13 + [_I] * 6 + [_P],
        # B, T, D, O, K -> workspace bytes of the hopper route (0: not taken)
        "h36x_gn_relu_cconv_bwd_hopper_workspace": [_I] * 5,
        # x, scale, bias, w, g, mean, rstd, ws, da, part, dx, dw, dscale,
        # dbias, B, T, D, O, K, G, stream
        "h36x_gn_relu_cconv_bwd_hopper": [_P] * 14 + [_I] * 6 + [_P],
    },
    "regressor": {
        # phi, w1, b1, w2, b2, w3, b3, out, N, D, H, out_dim, iters, stream
        "h36x_joint_regressor": [_P] * 8 + [_I] * 5 + [_P],
        # N, D, H, out_dim -> workspace bytes of the fast route (0: not taken)
        "h36x_joint_regressor_fast_workspace": [_I] * 4,
        # phi, w1p, w1y, w2, w3p (bf16), b1, b2, b3, ws, out,
        # N, D, H, out_dim, iters, stream
        "h36x_joint_regressor_fast": [_P] * 10 + [_I] * 5 + [_P],
    },
    "regressor_bwd": {
        # N, H, P, iters -> workspace bytes
        "h36x_joint_regressor_bwd_workspace": [_I] * 4,
        # phi, w1, b1, w2, b2, w3, b3, g, ws, dphi, dw1, db1, dw2, db2, dw3,
        # db3, N, D, H, P, iters, stream
        "h36x_joint_regressor_bwd": [_P] * 16 + [_I] * 5 + [_P],
        # N, D, H, P, iters -> workspace bytes of the hopper route (0: not taken)
        "h36x_joint_regressor_bwd_hopper_workspace": [_I] * 5,
        # as h36x_joint_regressor_bwd, the workspace that of the hopper route
        "h36x_joint_regressor_bwd_hopper": [_P] * 16 + [_I] * 5 + [_P],
    },
    "bottleneck": {
        # x, w1, b1, w2, b2, w3p, b3p, a_ws, b_ws, out,
        # B, H, W, C_in, C_mid, C_out, has_proj, dtype, route, stream
        "h36x_fused_bottleneck": [_P] * 10 + [_I] * 9 + [_P],
    },
    "matmul_probe": {
        # x, y, y_ws, out, M, K, N, mode, tile, stream
        "h36x_matmul_probe": [_P] * 4 + [_I] * 5 + [_P],
    },
}
RESTYPES = {"h36x_joint_regressor_bwd_workspace": ctypes.c_size_t,
            "h36x_joint_regressor_bwd_hopper_workspace": ctypes.c_size_t,
            "h36x_gn_relu_cconv_bwd_hopper_workspace": ctypes.c_size_t,
            "h36x_gn_relu_cconv_fast_workspace": ctypes.c_size_t,
            "h36x_joint_regressor_fast_workspace": ctypes.c_size_t}

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
    # the key covers the shared headers too, so a changed header rebuilds
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
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
    try:  # loaded already: no lock on the launch path
        return [_libs[n] for n in names]
    except KeyError:
        pass
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
                fn.restype = RESTYPES.get(sym, ctypes.c_int)
            _libs[n] = lib
        return [_libs[n] for n in names]


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error (a launch refused
    for its shared memory or thread count never runs, and a later
    synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def require_cuda_f32(what: str, batch_strided=(), **tensors) -> None:
    """The kernels take contiguous float32 CUDA tensors on one device. A
    tensor named in `batch_strided` may instead be the leading rows of each
    sample of a longer buffer: dense within a sample, the samples a whole
    number of rows apart."""
    device = None
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, expected cuda")
        if t.dtype is not torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected float32")
        if not (t.is_contiguous() or (
                name in batch_strided and t.dim() > 1 and t.shape[0] > 0
                and t[0].is_contiguous() and t.stride(0) % t.shape[-1] == 0)):
            raise ValueError(f"{what}: {name} must be contiguous"
                             + (" within each sample" if name in batch_strided else ""))
        index = t.get_device()
        if device is None:
            device = index
        elif index != device:
            raise ValueError(f"{what}: {name} is on {t.device}, others on cuda:{device}")


def require_cuda_bf16(what: str, device, **tensors) -> None:
    """The fast routes' weight copies: contiguous bfloat16 tensors on
    `device`."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
        if t.dtype is not torch.bfloat16:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def needs_grad(*tensors) -> bool:
    """Whether an op's call must record an autograd node: grad mode on and
    some input requiring a gradient. The serving paths (inference mode)
    skip the node and its cost."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def count_launch(fn) -> None:
    """Add one to `fn.launches` for a call that launched its kernel. A call
    that a CUDA graph capture records launches nothing and is not counted;
    a replay of the graph runs the kernel without its wrapper."""
    if not torch.cuda.is_current_stream_capturing():
        fn.launches += 1


def stream_of(t: torch.Tensor) -> int:
    """The raw cudaStream_t of the current stream of t's device (what the
    entry points launch on; inside a CUDA graph capture, the capture
    stream), without building a torch.cuda.Stream object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def on_device(dev: torch.device):
    """A context on `dev`'s CUDA device: a no-op when it is the current one
    already (the serving paths' case), torch.cuda.device otherwise."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
