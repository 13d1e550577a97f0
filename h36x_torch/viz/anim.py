"""Skeleton / reprojection animation viewers (host tools, numpy and
matplotlib; counterpart of h36x/viz/anim.py).

The reference's four viewers in one implementation: video + 3D, frame + GT
2D + reprojected 2D + 3D (the visual check of the crop / K geometry), the
feature-space variant without video, and the raw ingested-pickle viewer.
matplotlib is imported inside the viewers only, so a host without it
imports this module and everything else of the package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from h36x_torch.geometry.skeleton import H36M_EDGES
from h36x_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD


def _project(joints3d: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Pinhole projection through K on the CPU (project_with_K)."""
    import torch

    from h36x_torch.geometry.camera import project_with_K

    return project_with_K(torch.as_tensor(np.asarray(joints3d, np.float32)),
                          torch.as_tensor(np.asarray(K, np.float32))).numpy()


def to_uint8_rgb(frame_chw: np.ndarray) -> np.ndarray:
    """CHW float frame (possibly ImageNet-normalized) -> HWC uint8 RGB.

    As the reference's viewer: values outside [-0.5, 1.5] are taken as
    normalized and de-normalized first.
    """
    f = np.asarray(frame_chw, dtype=np.float32)
    if f.min() < -0.5 or f.max() > 1.5:
        f = np.transpose(f, (1, 2, 0))
        f = (f * IMAGENET_STD) + IMAGENET_MEAN
        return (np.clip(f, 0.0, 1.0) * 255.0).astype(np.uint8)
    if f.max() <= 1.5:
        f = f * 255.0
    return np.transpose(np.clip(f, 0, 255).astype(np.uint8), (1, 2, 0))


def _frame_to_hwc_uint8(frame: np.ndarray) -> np.ndarray:
    """Accept CHW or HWC, float or uint8."""
    if frame.ndim == 3 and frame.shape[0] in (1, 3) and frame.shape[-1] not in (1, 3):
        if frame.dtype == np.uint8:
            # u8 can never be ImageNet-normalized: transpose only — the
            # denormalize heuristic in to_uint8_rgb would saturate it white
            return np.transpose(frame, (1, 2, 0))
        return to_uint8_rgb(frame)
    if frame.dtype == np.uint8:
        return frame
    f = np.asarray(frame, np.float32)
    if f.max() <= 1.5:
        f = f * 255.0
    return np.clip(f, 0, 255).astype(np.uint8)


def save_animation(anim, path: str, fps: int = 10) -> str:
    """Write a viewer animation to disk, the headless companion of show()
    (a GPU host rarely has a display). Writer by extension: .gif -> pillow
    (always available), .html -> the standalone HTML writer, .mp4 -> ffmpeg
    when on PATH."""
    import matplotlib.animation as manim

    path = str(path)
    ext = path.rsplit(".", 1)[-1].lower() if "." in path else ""
    if ext == "gif":
        writer = manim.PillowWriter(fps=fps)
    elif ext in ("htm", "html"):
        writer = manim.HTMLWriter(fps=fps)
    elif ext == "mp4":
        if not manim.writers.is_available("ffmpeg"):
            raise RuntimeError(
                "saving .mp4 needs ffmpeg, which is not on PATH — save a "
                ".gif (pillow, always available) or .html instead")
        writer = manim.FFMpegWriter(fps=fps)
    else:
        raise ValueError(
            f"unsupported animation extension {ext!r} "
            "(use .gif, .html, or .mp4)")
    anim.save(path, writer=writer)
    return path


def _finish(anim, show: bool, save: str, fps: int):
    """Shared viewer tail: save and/or show, return the live animation
    (callers must keep the reference or matplotlib garbage-collects the
    timer mid-animation)."""
    import matplotlib.pyplot as plt

    if save or show:
        plt.tight_layout()
    if save:
        save_animation(anim, save, fps=fps)
        print(f"saved animation -> {save}")
    if show:
        plt.show()
    elif save:
        # save-only: the artifact is on disk, so release the figure from
        # pyplot's global registry — a loop saving one animation per sample
        # would otherwise grow a live Figure per call (and hit matplotlib's
        # "more than 20 figures" warning). The animation object itself is
        # still returned for callers that keep it.
        plt.close(anim._fig)
    return anim


def _pad_limits(lo: float, hi: float, p: float = 0.05):
    r = (hi - lo) if hi > lo else 1.0
    return lo - p * r, hi + p * r


def _setup_3d_axis(ax, js3, point_size, line_width, elev=25, azim=290):
    xs, ys, zs = js3[..., 0], js3[..., 1], js3[..., 2]
    ax.set_xlim(*_pad_limits(xs.min(), xs.max()))
    ax.set_ylim(*_pad_limits(ys.min(), ys.max()))
    ax.set_zlim(*_pad_limits(zs.min(), zs.max()))
    ax.view_init(elev=elev, azim=azim)
    scat = ax.scatter(js3[0, :, 0], js3[0, :, 1], js3[0, :, 2], s=point_size)
    lines = []
    for a, b in H36M_EDGES:
        (ln,) = ax.plot(
            [js3[0, a, 0], js3[0, b, 0]],
            [js3[0, a, 1], js3[0, b, 1]],
            [js3[0, a, 2], js3[0, b, 2]],
            linewidth=line_width,
        )
        lines.append(ln)
    return scat, lines


def _update_3d(scat, lines, js3, t):
    scat._offsets3d = (js3[t, :, 0], js3[t, :, 1], js3[t, :, 2])
    for ln, (a, b) in zip(lines, H36M_EDGES):
        ln.set_data([js3[t, a, 0], js3[t, b, 0]], [js3[t, a, 1], js3[t, b, 1]])
        ln.set_3d_properties([js3[t, a, 2], js3[t, b, 2]])


def _setup_2d_overlay(ax, js2, point_size, line_width):
    scat = ax.scatter(js2[0, :, 0], js2[0, :, 1], s=point_size)
    lines = []
    for a, b in H36M_EDGES:
        (ln,) = ax.plot(
            [js2[0, a, 0], js2[0, b, 0]], [js2[0, a, 1], js2[0, b, 1]],
            linewidth=line_width,
        )
        lines.append(ln)
    return scat, lines


def _update_2d(scat, lines, js2, t):
    scat.set_offsets(js2[t])
    for ln, (a, b) in zip(lines, H36M_EDGES):
        ln.set_data([js2[t, a, 0], js2[t, b, 0]], [js2[t, a, 1], js2[t, b, 1]])


def plot_batch_sample(video, joints, sample_idx: int = 0, fps: int = 10,
                      show: bool = True, save: str = ""):
    """Video frame + animated 3D skeleton (the reference's visualize.py)."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    vid = np.asarray(video)[sample_idx]
    js3 = np.asarray(joints)[sample_idx]
    frames = [_frame_to_hwc_uint8(vid[t]) for t in range(vid.shape[0])]

    fig = plt.figure(figsize=(10, 4))
    ax_img = fig.add_subplot(1, 2, 1)
    ax_3d = fig.add_subplot(1, 2, 2, projection="3d")
    im = ax_img.imshow(frames[0])
    ax_img.axis("off")
    ax_img.set_title("Video")
    ax_3d.set_title("Skeleton 3D")
    scat, lines = _setup_3d_axis(ax_3d, js3, 20, 1.5, elev=45, azim=-90)

    def update(t):
        im.set_data(frames[t])
        _update_3d(scat, lines, js3, t)
        return [im, scat] + lines

    anim = FuncAnimation(fig, update, frames=len(frames), interval=1000 // fps, blit=False)
    return _finish(anim, show, save, fps)


def plot_sequence_3d(joints3d, sample_idx: int = 0, fps: int = 10,
                     point_size: int = 18, line_width: int = 2,
                     show: bool = True, save: str = ""):
    """3D-skeleton-only animation: the viewer of last resort for NPZs that
    carry neither video frames nor 2D joints (predict output)."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    js3 = np.asarray(joints3d)[sample_idx]
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(1, 1, 1, projection="3d")
    ax.set_title("Skeleton 3D")
    scat, lines = _setup_3d_axis(ax, js3, point_size, line_width)

    def update(t):
        _update_3d(scat, lines, js3, t)
        return [scat] + lines

    anim = FuncAnimation(fig, update, frames=js3.shape[0],
                         interval=1000 // fps, blit=False)
    return _finish(anim, show, save, fps)


def plot_batch_sample_2d_2dproj_3d(
    video, joints3d, joints2d, K,
    sample_idx: int = 0, fps: int = 10, point_size: int = 18, line_width: int = 2,
    show: bool = True, save: str = "",
):
    """Frame+GT-2D | frame+reprojected-2D | 3D, the geometry check (the
    reference's visualize_2d.py). Reprojection is pinhole through K.

    K=None degrades like the no_video variant: the middle panel shows the
    GT 2D again instead of crashing on a missing-intrinsics NPZ."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation


    vid = np.asarray(video)[sample_idx]
    js3 = np.asarray(joints3d)[sample_idx]
    js2 = np.asarray(joints2d)[sample_idx]
    t_len = vid.shape[0]
    if K is None:
        proj2 = js2
    else:
        Kk = np.asarray(K)
        # (B,3,3) batched and (B,T,3,3) per-frame intrinsics both select
        # the sample; a bare (3,3) passes through
        Kk = Kk[sample_idx] if Kk.ndim >= 3 else Kk
        proj2 = _project(js3, Kk)
    frames = [_frame_to_hwc_uint8(vid[t]) for t in range(t_len)]
    h, w = frames[0].shape[:2]

    fig = plt.figure(figsize=(15, 4))
    ax_gt = fig.add_subplot(1, 3, 1)
    ax_prj = fig.add_subplot(1, 3, 2)
    ax_3d = fig.add_subplot(1, 3, 3, projection="3d")
    ax_gt.set_title("Frame + GT 2D joints")
    ax_prj.set_title("Frame + Reprojected 2D joints" if K is not None
                     else "Frame + GT 2D joints (no K)")
    ax_3d.set_title("Skeleton 3D")

    im_gt = ax_gt.imshow(frames[0])
    im_prj = ax_prj.imshow(frames[0])
    for ax in (ax_gt, ax_prj):
        ax.axis("off")
        ax.set_xlim(0, w - 1)
        ax.set_ylim(h - 1, 0)

    scat_gt, lines_gt = _setup_2d_overlay(ax_gt, js2, point_size, line_width)
    scat_prj, lines_prj = _setup_2d_overlay(ax_prj, proj2, point_size, line_width)
    scat3, lines3 = _setup_3d_axis(ax_3d, js3, point_size, line_width)

    def update(t):
        im_gt.set_data(frames[t])
        im_prj.set_data(frames[t])
        _update_2d(scat_gt, lines_gt, js2, t)
        _update_2d(scat_prj, lines_prj, proj2, t)
        _update_3d(scat3, lines3, js3, t)
        return [im_gt, im_prj, scat_gt, scat_prj, scat3] + lines_gt + lines_prj + lines3

    anim = FuncAnimation(fig, update, frames=t_len, interval=1000 // fps, blit=False)
    return _finish(anim, show, save, fps)


def plot_batch_sample_2d_2dproj_3d_no_video(
    joints3d, joints2d, K,
    sample_idx: int = 0, fps: int = 10, point_size: int = 18, line_width: int = 2,
    invert_y: bool = True, equal_aspect: bool = True, show: bool = True,
    save: str = "", joints3d_display=None,
):
    """Feature-space variant without frames (the reference's
    visualize_features.py).

    K=None skips the reprojection math (no intrinsics available — e.g. raw
    pickles without a camera file): the middle panel shows the GT 2D again
    rather than a degenerate projection through a fake K.

    joints3d_display optionally decouples the 3D PANEL's joints from the
    reprojection source: only raw camera-frame coordinates project through
    K, but the panel usually wants them pelvis-centered (read_pkl.py)."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation


    js3_panel = np.asarray(
        joints3d if joints3d_display is None else joints3d_display
    )[sample_idx]
    js3 = np.asarray(joints3d)[sample_idx]
    js2 = np.asarray(joints2d)[sample_idx]
    t_len = js3.shape[0]
    if K is None:
        proj2, prj_title = js2, "GT 2D (no K for reprojection)"
    else:
        Kk = np.asarray(K)
        # select the sample for (B,3,3) and (B,T,3,3) alike
        Kk = Kk[sample_idx] if Kk.ndim >= 3 else Kk
        proj2 = _project(js3, Kk)
        prj_title = "Reprojected 2D joints"

    fig = plt.figure(figsize=(15, 4))
    ax_gt = fig.add_subplot(1, 3, 1)
    ax_prj = fig.add_subplot(1, 3, 2)
    ax_3d = fig.add_subplot(1, 3, 3, projection="3d")
    ax_gt.set_title("GT 2D joints")
    ax_prj.set_title(prj_title)
    ax_3d.set_title("Skeleton 3D")

    for ax, pts in ((ax_gt, js2), (ax_prj, proj2)):
        ax.set_xlim(*_pad_limits(pts[..., 0].min(), pts[..., 0].max()))
        lo, hi = _pad_limits(pts[..., 1].min(), pts[..., 1].max())
        ax.set_ylim((hi, lo) if invert_y else (lo, hi))
        if equal_aspect:
            ax.set_aspect("equal")

    scat_gt, lines_gt = _setup_2d_overlay(ax_gt, js2, point_size, line_width)
    scat_prj, lines_prj = _setup_2d_overlay(ax_prj, proj2, point_size, line_width)
    scat3, lines3 = _setup_3d_axis(ax_3d, js3_panel, point_size, line_width)

    def update(t):
        _update_2d(scat_gt, lines_gt, js2, t)
        _update_2d(scat_prj, lines_prj, proj2, t)
        _update_3d(scat3, lines3, js3_panel, t)
        return [scat_gt, scat_prj, scat3] + lines_gt + lines_prj + lines3

    anim = FuncAnimation(fig, update, frames=t_len, interval=1000 // fps, blit=False)
    return _finish(anim, show, save, fps)


def plot_raw_sequence(
    gt_poses_path: str, video_path: Optional[str] = None,
    frame_skip: int = 5, max_frames: int = 100, fps: int = 10,
    show: bool = True, save: str = "",
):
    """Sanity viewer over raw ingested pickles (the reference's read_pkl.py):
    pelvis-centered 3D skeleton, optionally next to decoded frames."""
    import pickle

    with open(gt_poses_path, "rb") as f:
        data = pickle.load(f)
    js3 = np.asarray(data["3d"], dtype=np.float32)[::frame_skip][:max_frames]
    js3 = js3 - js3[:, :1]  # pelvis-center

    if video_path is not None:
        from h36x_torch.data.clips import decode_clip

        video = decode_clip(video_path, 0, js3.shape[0], frame_skip)
        return plot_batch_sample(video[None], js3[None], 0, fps=fps,
                                 show=show, save=save)

    # Real intrinsics from the sibling camera_wext.pkl (ingested layout)
    # make the reprojection panel meaningful; the raw (uncentered,
    # camera-frame) 3D is what projects through K. Without the camera
    # file K=None shows GT 2D instead of a degenerate identity-K panel.
    import os

    cam_path = os.path.join(os.path.dirname(gt_poses_path), "camera_wext.pkl")
    K = None
    js3_for_proj = js3
    if os.path.exists(cam_path):
        with open(cam_path, "rb") as f:
            cam = pickle.load(f)
        f_xy, c_xy = np.asarray(cam["f"]).ravel(), np.asarray(cam["c"]).ravel()
        K = np.array([[f_xy[0], 0, c_xy[0]], [0, f_xy[1], c_xy[1]], [0, 0, 1]],
                     np.float32)
        js3_for_proj = np.asarray(data["3d"], np.float32)[::frame_skip][:max_frames]
    return plot_batch_sample_2d_2dproj_3d_no_video(
        js3_for_proj[None],
        np.asarray(data["2d"], np.float32)[::frame_skip][:max_frames][None],
        K, 0, fps=fps, show=show, save=save,
        # the 3D panel keeps the pelvis-centered skeleton (read_pkl.py);
        # js3_for_proj stays raw camera-frame because that is what K projects
        joints3d_display=js3[None],
    )
