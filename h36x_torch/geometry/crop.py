"""Person-crop geometry, host-side numpy (counterpart of
h36x/geometry/crop.py): the square crop from 2D joints and the joint
remapping into the cropped and resized frame."""

from __future__ import annotations

import numpy as np


def compute_square_crop_from_2d(
    joints2d, img_h: int, img_w: int, scale: float = 1.6
) -> np.ndarray:
    """Square crop box (top, left, side, side) covering the 2D joints:
    centred on the joints' bounding box, side = scale * its larger extent,
    clamped into the image and rounded to integer pixels. int64 (4,)."""
    pts = np.asarray(joints2d, dtype=np.float64).reshape(-1, 2)

    x_min, y_min = pts.min(axis=0)
    x_max, y_max = pts.max(axis=0)

    cx = 0.5 * (x_min + x_max)
    cy = 0.5 * (y_min + y_max)

    w = max(x_max - x_min, 1.0)
    h = max(y_max - y_min, 1.0)
    side = scale * max(w, h)

    left = cx - 0.5 * side
    top = cy - 0.5 * side
    left = float(np.clip(left, 0.0, img_w - side))
    top = float(np.clip(top, 0.0, img_h - side))

    left_i = int(round(left))
    top_i = int(round(top))
    side_i = int(round(side))
    # a side larger than the image makes the clip above negative: clamp to a
    # valid in-image box
    left_i = max(0, left_i)
    top_i = max(0, top_i)
    side_i = max(1, min(side_i, img_w - left_i, img_h - top_i))
    return np.array([top_i, left_i, side_i, side_i], dtype=np.int64)


def adjust_joints2d_after_crop_and_resize(joints2d, box, out_size: int = 224):
    """Remap pixel joints into the cropped + resized frame; box = (top,
    left, h, w)."""
    top, left, hh, ww = (float(v) for v in np.asarray(box).reshape(4))
    j = np.asarray(joints2d, dtype=np.float32).copy()
    j[..., 0] = (j[..., 0] - left) * (out_size / ww)
    j[..., 1] = (j[..., 1] - top) * (out_size / hh)
    return j
