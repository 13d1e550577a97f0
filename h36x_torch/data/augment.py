"""The 4-variant augmentation suite on the host (counterpart of the host
half of h36x/data/augment.py): orig / color-jitter / horizontal-flip /
temporal-reverse.

Both extraction schedulers jitter the u8 crops on the decode workers
(:func:`jitter_u8`): the port's native library when it is built, else the
numpy chain (cv2's HSV conversion for the hue where cv2 is installed, exact
numpy otherwise). Temporal-reverse needs no pixel work: its features are
the orig features reversed in time. The joint-side adjustments mirror the
pixel-side ops.
"""

from __future__ import annotations

import numpy as np

from h36x_torch.geometry.skeleton import flip_permutation

AUG_NAMES = ("orig", "cjitter", "hflip", "trev")

_FLIP_PERM = flip_permutation()
_GRAY = np.array([0.2989, 0.587, 0.114], dtype=np.float32)


def _np_blend(a, b, factor):
    return np.clip(factor * a + (1.0 - factor) * b, 0.0, 1.0)


def _np_hue_cv2(v, shift):
    """cv2-backed hue shift: matches :func:`_np_hue` to about 1e-6 at ~40x
    its speed. Raises ImportError where cv2 is not installed."""
    import cv2

    out = np.empty_like(v)
    deg = shift * 360.0
    for i in range(v.shape[0]):
        hsv = cv2.cvtColor(v[i], cv2.COLOR_RGB2HSV)
        hsv[..., 0] = (hsv[..., 0] + deg) % 360.0
        out[i] = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    return out


def _np_hue(v, shift):
    r, g, b = v[..., 0], v[..., 1], v[..., 2]
    maxc = v.max(axis=-1)
    minc = v.min(axis=-1)
    rng_ = maxc - minc
    sat = np.where(maxc > 0, rng_ / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(rng_, 1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(rng_ > 0, (h / 6.0) % 1.0, 0.0)
    h = (h + shift) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = maxc * (1.0 - sat)
    q = maxc * (1.0 - f * sat)
    t = maxc * (1.0 - (1.0 - f) * sat)
    i = i.astype(np.int32) % 6
    r = np.choose(i, [maxc, q, p, p, t, maxc])
    g = np.choose(i, [t, maxc, maxc, q, p, p])
    b = np.choose(i, [p, p, t, maxc, maxc, q])
    return np.stack([r, g, b], axis=-1)


def sample_jitter_params(
    rng: np.random.Generator,
    brightness: float = 0.3,
    contrast: float = 0.3,
    saturation: float = 0.2,
    hue: float = 0.05,
):
    """Draw one (order, brightness, contrast, saturation, hue) factor set;
    keyed per clip, per video or per frame by the caller."""
    order = rng.permutation(4)
    fb = rng.uniform(1.0 - brightness, 1.0 + brightness)
    fc = rng.uniform(1.0 - contrast, 1.0 + contrast)
    fs = rng.uniform(1.0 - saturation, 1.0 + saturation)
    fh = rng.uniform(-hue, hue)
    return order, fb, fc, fs, fh


def apply_jitter_params(video01: np.ndarray, params) -> np.ndarray:
    """Apply a :func:`sample_jitter_params` factor set to (T, H, W, 3) or
    (H, W, 3) video in [0, 1]. Every op's statistics are per frame, so
    applying per frame and per window commute."""
    order, fb, fc, fs, fh = params
    v = video01
    for op in order:
        if op == 0:
            v = np.clip(v * fb, 0.0, 1.0)
        elif op == 1:
            gray_mean = (v @ _GRAY).mean(axis=(-2, -1), keepdims=True)[..., None]
            v = _np_blend(v, gray_mean, fc)
        elif op == 2:
            v = _np_blend(v, (v @ _GRAY)[..., None], fs)
        else:
            try:
                v = _np_hue_cv2(v.reshape((-1,) + v.shape[-3:]), fh).reshape(v.shape)
            except ImportError:  # no cv2: the exact numpy hue
                v = _np_hue(v, fh)
    return v


def color_jitter_host(
    video01: np.ndarray,
    rng: np.random.Generator,
    brightness: float = 0.3,
    contrast: float = 0.3,
    saturation: float = 0.2,
    hue: float = 0.05,
) -> np.ndarray:
    """One factor set per clip, ops in a seeded random order; video01
    (T, H, W, 3) float32 in [0, 1]."""
    return apply_jitter_params(
        video01, sample_jitter_params(rng, brightness, contrast, saturation, hue)
    )


def jitter_u8(crops_u8: np.ndarray, params, n_threads: int = 4) -> np.ndarray:
    """(T, H, W, 3) u8 -> jittered u8, one quantize at the end: the native
    kernel when the library is built, else the numpy chain (the two may
    differ by +-1 on rint-boundary pixels, so one store never mixes them)."""
    from h36x_torch import native

    if native.jitter_available():
        return native.jitter_clip_u8(crops_u8, params, n_threads=n_threads)
    video01 = crops_u8.astype(np.float32) * (1.0 / 255.0)
    out = apply_jitter_params(video01, params)
    return np.clip(np.rint(out * 255.0), 0, 255).astype(np.uint8)


def make_clip_variants_u8(crops_u8: np.ndarray, rng: np.random.Generator):
    """(T, o, o, 3) u8 person crops -> the (orig, cjitter, hflip) u8 stack
    (3, T, o, o, 3)."""
    cj = jitter_u8(crops_u8, sample_jitter_params(rng))
    hf = crops_u8[:, :, ::-1, :]
    return np.stack([crops_u8, cj, hf])


def hflip_joints(joints3d: np.ndarray, joints2d: np.ndarray, K: np.ndarray, width: int):
    """Joint / K adjustment of a horizontal flip: joints2d x -> W - x,
    joints3d x -> -x, left and right joints swap, K's cx mirrors."""
    j2 = np.asarray(joints2d).copy()
    j3 = np.asarray(joints3d).copy()
    j2[..., 0] = width - j2[..., 0]
    j3[..., 0] = -j3[..., 0]
    j2 = j2[..., _FLIP_PERM, :]
    j3 = j3[..., _FLIP_PERM, :]
    Kf = np.asarray(K).copy()
    Kf[0, 2] = width - Kf[0, 2]
    return j3, j2, Kf


def reverse_joints(joints3d: np.ndarray, joints2d: np.ndarray):
    return np.asarray(joints3d)[::-1].copy(), np.asarray(joints2d)[::-1].copy()
