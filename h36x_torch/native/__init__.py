"""ctypes loader for the port's native host library (counterpart of
h36x/native/__init__.py): the threaded u8 crop + bilinear resize and the
fused photometric jitter of the extraction decode workers, the u8
horizontal flip and brightness / contrast / saturation jitter, and the zstd
frame decoder of the orbax checkpoint reader (`zstd.cpp`,
:mod:`h36x_torch.utils.zstd`).

`h36xio.cpp` here is a copy of h36x's source; `zstd.cpp` is the port's own.
At first use both are compiled into one library
with g++ (the flags of h36x's Makefile) into `build/h36x_torch/` at the
repository root, under a name keyed by a hash of the source and the flags,
and moved into place by an atomic rename: a concurrent build never loads
a half-written library and a changed source never loads a stale one.
Nothing is built into h36x's tree. Where the build fails every entry point
reports itself unavailable and the extraction callers take their numpy/cv2
path; a store records which backend wrote it (`crop_backend`,
`jitter_backend`), since the two differ by +-1 u8 on some pixels. The zstd
decoder has no other path: without the library it raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "h36xio.cpp"
SOURCES = (SOURCE, SOURCE.with_name("zstd.cpp"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "h36x_torch"
# -ffp-contract=off: no fused multiply-adds, so every f32 expression rounds
# as numpy's does (the jitter's parity with the numpy chain depends on it);
# -fopenmp-simd honours `#pragma omp simd` without an OpenMP runtime;
# -fno-trapping-math lets floor/rint vectorize with bit-identical results
FLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-pthread",
         "-ffp-contract=off", "-fopenmp-simd", "-fno-trapping-math")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_lock = threading.Lock()


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def _arch_flags() -> tuple:
    """-march=native where the compiler takes it (as h36x's Makefile)."""
    try:
        subprocess.run([_compiler(), "-march=native", "-E", "-x", "c++", os.devnull],
                       check=True, capture_output=True, timeout=60)
        return ("-march=native",)
    except (OSError, subprocess.SubprocessError):
        return ()


def _lib_path(flags) -> Path:
    key = hashlib.sha256(b"".join(p.read_bytes() for p in SOURCES)
                         + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libh36xio-{key}.so"


def _build() -> Optional[Path]:
    flags = FLAGS + _arch_flags()
    out = _lib_path(flags)
    if out.exists():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        subprocess.run([_compiler(), *flags, "-shared", "-o", str(tmp),
                        *map(str, SOURCES)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        return None


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on first call; None if unavailable.

    Thread-safe: first use happens from the decode pool, so build and load
    run under a lock, and `_tried` is set only after `_lib`, so a racing
    worker either sees the final state or waits for it (never a cv2
    fallback while the first caller is still building)."""
    if _lib is not None or _tried:
        return _lib
    with _load_lock:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    path = _build()
    try:
        lib = ctypes.CDLL(str(path)) if path is not None else None
    except OSError:
        lib = None
    if lib is not None:
        lib.h36x_crop_resize_clip_u8.restype = ctypes.c_int
        lib.h36x_crop_resize_clip_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.h36x_hflip_clip_u8.restype = ctypes.c_int
        lib.h36x_hflip_clip_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int
        ]
        lib.h36x_bcs_jitter_u8.restype = ctypes.c_int
        lib.h36x_bcs_jitter_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.h36x_jitter_clip_u8.restype = ctypes.c_int
        lib.h36x_jitter_clip_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.h36x_zstd_decompress.restype = ctypes.c_int
        lib.h36x_zstd_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_int,
        ]
        lib.h36x_zstd_free.restype = None
        lib.h36x_zstd_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    _tried = True  # after _lib: the unlocked fast path keys on _tried
    return _lib


def available() -> bool:
    return load() is not None


def jitter_available() -> bool:
    """True when the full-jitter kernel is loadable (the port builds its
    library from the current source, so: whenever the library is)."""
    return available()


def crop_resize_clip(frames: np.ndarray, top: int, left: int, side: int,
                     out_size: int, n_threads: int = 4) -> np.ndarray:
    """(T, H, W, 3) u8 -> (T, out, out, 3) u8 square crop + bilinear resize."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, h, w, c = frames.shape
    assert c == 3
    out = np.empty((t, out_size, out_size, 3), np.uint8)
    rc = lib.h36x_crop_resize_clip_u8(
        frames.ctypes.data, t, h, w, int(top), int(left), int(side),
        out.ctypes.data, out_size, n_threads,
    )
    if rc != 0:
        raise ValueError(f"invalid crop box (top={top}, left={left}, side={side}) "
                         f"for frames {frames.shape}")
    return out


def hflip_clip(frames: np.ndarray, n_threads: int = 4) -> np.ndarray:
    """Horizontally flip (T, H, W, 3) u8 frames (returns a new array)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.array(frames, dtype=np.uint8, order="C")  # exactly one copy
    t, h, w, _ = out.shape
    lib.h36x_hflip_clip_u8(out.ctypes.data, t, h, w, n_threads)
    return out


def bcs_jitter_clip(frames: np.ndarray, fb: float, fc: float, fs: float, order,
                    n_threads: int = 4) -> np.ndarray:
    """Brightness / contrast / saturation jitter on a copy of (T, H, W, 3)
    u8 frames, the ops in `order` (0, 1, 2; hue is host-side)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.array(frames, dtype=np.uint8, order="C")
    t, h, w, _ = out.shape
    order_arr = np.ascontiguousarray(order, dtype=np.int32)
    rc = lib.h36x_bcs_jitter_u8(
        out.ctypes.data, t, h, w, float(fb), float(fc), float(fs),
        order_arr.ctypes.data, len(order_arr), n_threads,
    )
    if rc != 0:
        raise ValueError(
            f"bcs_jitter_clip: unknown op in order={list(order_arr)} "
            "(only 0=brightness, 1=contrast, 2=saturation; hue is host-side)")
    return out


def jitter_clip_u8(frames: np.ndarray, params, n_threads: int = 4) -> np.ndarray:
    """The 4-op photometric jitter on (T, H, W, 3) u8 frames: the f32 chain
    of `augment.apply_jitter_params` on frames / 255 (brightness, contrast,
    saturation, HSV hue in the sampled order), then one round-half-even
    quantize. `params` is a `sample_jitter_params` tuple."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    order, fb, fc, fs, fh = params
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, h, w, c = frames.shape
    assert c == 3
    out = np.empty_like(frames)
    order_arr = np.ascontiguousarray(order, dtype=np.int32)
    rc = lib.h36x_jitter_clip_u8(
        frames.ctypes.data, out.ctypes.data, t, h, w,
        float(fb), float(fc), float(fs), float(fh),
        order_arr.ctypes.data, len(order_arr), n_threads,
    )
    if rc != 0:
        raise ValueError(f"jitter_clip_u8: unknown op in order={list(order_arr)} "
                         "(valid: 0=brightness, 1=contrast, 2=saturation, 3=hue)")
    return out
