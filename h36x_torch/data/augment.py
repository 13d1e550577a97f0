"""The 4-variant augmentation suite (counterpart of h36x/data/augment.py):
orig / color-jitter / horizontal-flip / temporal-reverse.

The pixel transforms (:func:`color_jitter`, :func:`hflip_video`,
:func:`reverse_time`) are torch ops on the video's device; `color_jitter`
draws its factors from a `torch.Generator` where h36x's takes a JAX key.
Both extraction schedulers jitter the u8 crops on the decode workers
(:func:`jitter_u8`): the port's native library when it is built, else the
numpy chain (cv2's HSV conversion for the hue where cv2 is installed, exact
numpy otherwise). Temporal-reverse needs no pixel work: its features are
the orig features reversed in time. The joint-side adjustments mirror the
pixel-side ops.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from h36x_torch.geometry.skeleton import flip_permutation

AUG_NAMES = ("orig", "cjitter", "hflip", "trev")

_FLIP_PERM = flip_permutation()
_GRAY = np.array([0.2989, 0.587, 0.114], dtype=np.float32)


# ---------------------------------------------------------------------------
# Photometric jitter (torch, channels-last, video (T, H, W, 3) in [0, 1])
# ---------------------------------------------------------------------------


def _gray(v: torch.Tensor) -> torch.Tensor:
    return v @ torch.as_tensor(_GRAY, device=v.device, dtype=v.dtype)


def _blend(a, b, factor):
    return torch.clamp(factor * a + (1.0 - factor) * b, 0.0, 1.0)


def _adjust_brightness(v, factor):
    return torch.clamp(v * factor, 0.0, 1.0)


def _adjust_contrast(v, factor):
    gray_mean = torch.mean(_gray(v), dim=(-2, -1), keepdim=True)[..., None]
    return _blend(v, gray_mean, factor)


def _adjust_saturation(v, factor):
    return _blend(v, _gray(v)[..., None], factor)


def _rgb_to_hsv(v):
    r, g, b = v[..., 0], v[..., 1], v[..., 2]
    maxc = torch.amax(v, dim=-1)
    minc = torch.amin(v, dim=-1)
    val = maxc
    rng = maxc - minc
    zero = torch.zeros_like(maxc)
    sat = torch.where(maxc > 0, rng / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.clamp(rng, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng > 0, torch.remainder(h / 6.0, 1.0), zero)
    return h, sat, val


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int64), 6)[..., None]

    def choose(*options):
        return torch.gather(torch.stack(options, dim=-1), -1, i)[..., 0]

    r = choose(v, q, p, p, t, v)
    g = choose(t, v, v, q, p, p)
    b = choose(p, p, t, v, v, q)
    return torch.stack([r, g, b], dim=-1)


def _adjust_hue(v, shift):
    h, s, val = _rgb_to_hsv(v)
    h = torch.remainder(h + shift, 1.0)
    return _hsv_to_rgb(h, s, val)


# RGB -> YIQ (NTSC); a hue rotation is a rotation of the (I, Q) chroma plane
_RGB2YIQ = np.array(
    [[0.299, 0.587, 0.114],
     [0.595716, -0.274453, -0.321263],
     [0.211456, -0.522591, 0.311135]],
    dtype=np.float32,
)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ).astype(np.float32)


def _adjust_hue_yiq(v, shift):
    """Hue rotation as one 3x3 pixel matmul: the (I, Q) plane turned by
    -2 pi shift (+shift in HSV moves red toward green; +theta in (I, Q)
    toward blue). Luma is kept exactly; at |shift| <= 0.05 it follows the
    HSV hue shift's direction and size."""
    theta = -2.0 * math.pi * float(shift)
    c, s = math.cos(theta), math.sin(theta)
    rot = torch.tensor([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]],
                       dtype=torch.float32)
    t = torch.from_numpy(_YIQ2RGB) @ rot @ torch.from_numpy(_RGB2YIQ)
    return torch.clamp(v @ t.T.to(device=v.device, dtype=v.dtype), 0.0, 1.0)


def _apply_jitter(video01, order, fb, fc, fs, fh, hue_mode: str = "yiq"):
    """The four ops in `order` (0 brightness, 1 contrast, 2 saturation, 3
    hue) with the factors given."""
    hue_fn = _adjust_hue_yiq if hue_mode == "yiq" else _adjust_hue
    ops = (
        lambda v: _adjust_brightness(v, fb),
        lambda v: _adjust_contrast(v, fc),
        lambda v: _adjust_saturation(v, fs),
        lambda v: hue_fn(v, fh),
    )
    out = video01
    for op in order:
        out = ops[int(op)](out)
    return out


def color_jitter(
    video01: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    brightness: float = 0.3,
    contrast: float = 0.3,
    saturation: float = 0.2,
    hue: float = 0.05,
    hue_mode: str = "yiq",
) -> torch.Tensor:
    """One factor set per clip, ops applied in a random order, both drawn
    from `generator` (a torch.Generator; torch's default one when None),
    on video01's device.

    hue_mode 'yiq' (default) rotates the YIQ chroma plane, one 3x3 pixel
    matmul; 'hsv' keeps torchvision's exact HSV semantics, which the host
    jitter of the extraction path uses."""
    if hue_mode not in ("yiq", "hsv"):
        raise ValueError(f"hue_mode {hue_mode!r}: 'yiq' or 'hsv'")
    g_dev = generator.device if generator is not None else "cpu"
    order = torch.randperm(4, generator=generator, device=g_dev).tolist()
    u = torch.rand(4, generator=generator, device=g_dev, dtype=torch.float64).tolist()
    fb = 1.0 - brightness + 2.0 * brightness * u[0]
    fc = 1.0 - contrast + 2.0 * contrast * u[1]
    fs = 1.0 - saturation + 2.0 * saturation * u[2]
    fh = -hue + 2.0 * hue * u[3]
    return _apply_jitter(video01, order, fb, fc, fs, fh, hue_mode)


def hflip_video(video: torch.Tensor) -> torch.Tensor:
    """Mirror the W axis of (..., H, W, C) video."""
    return torch.flip(video, dims=(-2,))


def reverse_time(video: torch.Tensor, time_axis: int = 0) -> torch.Tensor:
    return torch.flip(video, dims=(time_axis,))


# ---------------------------------------------------------------------------
# Host (numpy) photometric jitter: the extraction decode workers'
# ---------------------------------------------------------------------------


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
