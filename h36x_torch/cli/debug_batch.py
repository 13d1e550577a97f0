"""CLI: pull one test-set batch through the feature path and dump a debug
NPZ (counterpart of h36x/cli/debug_batch.py). Host-only: no device is
touched."""

import argparse

from h36x_torch.config import TEST_SUBJECTS
from h36x_torch.data.features import FeatureClipDataset
from h36x_torch.train.results import dump_debug_batch


def main(argv=None):
    """Returns the saved payload."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True, help="feature-shard root")
    p.add_argument("--out", default="debug_batch.npz")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--subjects", type=int, nargs="+", default=list(TEST_SUBJECTS))
    args = p.parse_args(argv)

    ds = FeatureClipDataset(args.root, subjects=args.subjects, test_set=True)
    payload = dump_debug_batch(ds, args.out, args.batch_size)
    for key in ("video", "joints3d", "joints2d", "cam_K"):
        print(f"{key}: {payload[key].shape} {payload[key].dtype}")
    print(f"meta: list of {len(payload['meta'])}")
    print(f"Saved to {args.out}")
    return payload


if __name__ == "__main__":
    main()
