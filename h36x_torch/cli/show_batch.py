"""CLI: load a saved debug/results NPZ and run the animation viewers
(counterpart of h36x/cli/show_batch.py; the reference's
testing_dataloader.py).

    MPLBACKEND=Agg python -m h36x_torch.cli.show_batch batch.npz --save b.gif
"""

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("npz", help="debug_batch.npz / batch_result npz")
    p.add_argument("--sample", type=int, default=0)
    p.add_argument("--mode", choices=["video3d", "reproject", "features"],
                   default="reproject")
    p.add_argument("--joints", choices=["auto", "gt", "pred"], default="auto",
                   help="which 3D skeleton to animate: auto prefers the "
                        "model's predicted3djoints when the NPZ carries "
                        "them (results / predict output), else GT")
    p.add_argument("--save", default="",
                   help="write the animation to this file instead of "
                        "opening a window (.gif/.html always work; .mp4 "
                        "needs ffmpeg) — the headless-host path")
    p.add_argument("--fps", type=int, default=10)
    args = p.parse_args(argv)
    view = {"show": not args.save, "save": args.save, "fps": args.fps}

    from h36x_torch.viz import (
        plot_batch_sample,
        plot_batch_sample_2d_2dproj_3d,
        plot_batch_sample_2d_2dproj_3d_no_video,
        plot_sequence_3d,
    )

    data = np.load(args.npz, allow_pickle=True)
    which = args.joints
    if which == "auto":
        which = "pred" if "predicted3djoints" in data else "gt"
    if which == "pred":
        if "predicted3djoints" not in data:
            raise SystemExit(f"{args.npz} carries no predicted3djoints "
                             "(use --joints gt)")
        j3d = data["predicted3djoints"]
    else:
        j3d = data["joints3d"]
    print(f"3D skeleton: {'model prediction' if which == 'pred' else 'GT'} "
          f"(--joints {args.joints})")
    # predict NPZs carry no joints2d; only the reprojection panels
    # need it, so video3d must not crash on its absence
    j2d = data["joints2d"] if "joints2d" in data else None
    K = data["cam_K"] if "cam_K" in data else (
        data["K"] if "K" in data else None)

    has_video = "video" in data and data["video"].ndim >= 5
    if args.mode == "video3d":
        if not has_video:
            # predict NPZs carry neither video nor joints2d: the 3D
            # animation must still be viewable, not a circular "use the
            # other mode" dead-end
            print(f"note: {args.npz} carries no video frames; showing the "
                  "3D skeleton alone")
            plot_sequence_3d(j3d, args.sample, **view)
            return
        plot_batch_sample(data["video"], j3d, args.sample, **view)
        return
    if j2d is None:
        print(f"note: {args.npz} carries no joints2d (the {args.mode!r} "
              "mode's reprojection panels need them); showing the 3D "
              "skeleton alone")
        plot_sequence_3d(j3d, args.sample, **view)
        return
    if args.mode == "features" or not has_video:
        plot_batch_sample_2d_2dproj_3d_no_video(j3d, j2d, K, args.sample,
                                                **view)
    else:
        plot_batch_sample_2d_2dproj_3d(data["video"], j3d, j2d, K, args.sample,
                                       **view)


if __name__ == "__main__":
    main()
