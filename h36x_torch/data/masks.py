"""Silhouette and mask helpers (counterpart of h36x/data/masks.py): the
bounding box of a silhouette stack, a mask cropped to its largest contour,
H36M's MATLAB-style .h5 silhouettes, and joints moved onto a new root.
OpenCV and h5py are imported inside the functions that need them."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def crop_from_silhouettes(silhouettes) -> Tuple[int, int, int, int]:
    """(x, y, w, h) bounding rect of the largest contour (by area) of the
    union mask over a silhouette stack."""
    import cv2

    union = np.asarray(silhouettes).any(axis=0)
    contours, _ = cv2.findContours(np.uint8(union) * 255, cv2.RETR_LIST,
                                   cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        raise ValueError("empty silhouette stack")
    return cv2.boundingRect(max(contours, key=cv2.contourArea))


def clean_mask_to_crop(mask: np.ndarray, x: int, y: int, w: int, h: int) -> np.ndarray:
    """A boolean mask cropped to (x, y, w, h) with everything but its
    largest contour zeroed. Returns uint8 {0, 255}."""
    import cv2

    # > 0 first: uint8 {0, 255} * 255 would wrap
    crop = (np.asarray(mask)[y : y + h, x : x + w] > 0).astype(np.uint8) * 255
    contours, _ = cv2.findContours(crop.copy(), cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return crop
    largest_i = max(range(len(contours)), key=lambda i: cv2.contourArea(contours[i]))
    out = np.dstack((crop, crop, crop))
    for i, cnt in enumerate(contours):
        if i != largest_i:
            cv2.drawContours(out, [cnt], 0, (0, 0, 0), -1)
    return cv2.split(out)[0]


def read_silhouettes(path: str, n_frames: Optional[int] = None) -> List[np.ndarray]:
    """An H36M MATLAB .h5 mask file -> a list of boolean masks (needs h5py)."""
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("reading silhouette .h5 files needs h5py") from e

    masks = []
    with h5py.File(path, "r") as f:
        refs = f["Masks"]
        count = len(refs) if n_frames is None else n_frames
        for i in range(count):
            mask = np.array(f[refs[i, 0]], dtype=bool)
            masks.append(np.fliplr(np.rot90(mask, 3)))
    return masks


def reroot_joints(joints: np.ndarray, new_root: np.ndarray, in_meter: bool = False):
    """A joint set moved onto a new root: joint 0 becomes new_root, the
    others keep their offsets from it (float64; / 1000 with in_meter)."""
    joints = np.asarray(joints, dtype=np.float64)
    out = np.empty_like(joints)
    out[0] = new_root
    out[1:] = new_root + joints[1:]
    if in_meter:
        out = out / 1000.0
    return out
