"""Host pixels to the device and features back: the person crop on the
decode workers, u8 rows through pinned memory to the card, and a
dispatch's features left there until the host reads them."""

from __future__ import annotations

import numpy as np
import torch

from h36x_torch.geometry.crop import compute_square_crop_from_2d


def crop_resize_frames(frames: np.ndarray, box, out_size: int) -> np.ndarray:
    """Crop (T, H, W, 3) u8 frames to `box` and bilinear-resize to out_size.

    The port's native library when it is built, else cv2; both sample with
    half-pixel centres (torchvision's resize(antialias=False)). Per-frame
    independent: cropping a subset of frames gives the same rows as
    cropping the whole clip (the dedup scheduler's crop cache relies on it).
    """
    from h36x_torch import native

    t_len = frames.shape[0]
    top, left, hh, _ww = (int(v) for v in np.asarray(box).reshape(4))
    if native.available():
        return native.crop_resize_clip(frames, top, left, hh, out_size)

    import cv2

    crop = frames[:, top : top + hh, left : left + hh]
    out = np.empty((t_len, out_size, out_size, 3), np.uint8)
    for t in range(t_len):
        out[t] = cv2.resize(crop[t], (out_size, out_size), interpolation=cv2.INTER_LINEAR)
    return out


def crop_resize_host(frames: np.ndarray, joints2d: np.ndarray, out_size: int,
                     crop_scale: float = 1.6):
    """Square person crop + bilinear resize on the host (decode worker):
    frames (T, H, W, 3) u8 -> ((T, out, out, 3) u8, box)."""
    _t_len, img_h, img_w, _ = frames.shape
    box = compute_square_crop_from_2d(joints2d, img_h, img_w, scale=crop_scale)
    return crop_resize_frames(frames, box, out_size), box


def rows_to_device(rows, n_rows: int, device: torch.device,
                   flip: int = 0) -> torch.Tensor:
    """u8 rows of one shape, zero rows after them up to `n_rows`, as one
    tensor on the device: each row copied once into a pinned buffer, which
    the host allocator hands out again once the card has read it, then one
    asynchronous copy. (Stacking, padding and pinning a stacked array
    would move every byte three times, twice into freshly mapped pages.)

    The last `flip` of `rows`, each (H, W, C), arrive mirrored along W:
    they are copied as given and mirrored on the device after the copy, in
    its stream. A mirrored view copied on the host (`row[:, ::-1]`) would
    move its bytes a pixel at a time."""
    shape = np.shape(rows[0])
    buf = torch.empty((n_rows,) + shape, dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    host = buf.numpy()
    for i, row in enumerate(rows):
        host[i] = row
    host[len(rows):] = 0
    frames = buf.to(device, non_blocking=True)
    if flip:
        mirrored = frames[len(rows) - flip:len(rows)]
        mirrored.copy_(mirrored.flip(2))
    return frames


_copy_streams: dict = {}


class DeviceFeatures:
    """One dispatch's features, left on the device until :meth:`numpy`.

    On the card an event marks the end of the dispatch's work on the
    compute stream; :meth:`numpy` copies on a side stream that waits only
    for that event, so a dispatch queued after this one is not waited for."""

    def __init__(self, feats: torch.Tensor):
        self.feats = feats
        self.event = None
        if feats.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def numpy(self, np_dtype) -> np.ndarray:
        if self.event is None:
            return np.asarray(self.feats.numpy(), dtype=np_dtype)
        dev = self.feats.device
        stream = _copy_streams.get(dev)
        if stream is None:
            stream = _copy_streams[dev] = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            stream.wait_event(self.event)
            host = self.feats.to("cpu")  # synchronizes this stream only
        return np.asarray(host.numpy(), dtype=np_dtype)
