"""CLI: raw Human3.6M ingest (counterpart of h36x/cli/ingest.py).

    python -m h36x_torch.cli.ingest --source-dir RAW --out-dir INGESTED \\
        [--subjects 1 5 6 7 8 9 11]

RAW holds metadata.xml and S{s}/{Videos, MyPoseFeatures/D2_Positions,
MyPoseFeatures/D3_Positions_mono}; pose files are .cdf (spacepy needed) or
their .npz/.npy siblings. A second run over the same tree writes nothing.
"""

from h36x_torch.config import IngestConfig, parse_into
from h36x_torch.data.ingest import ingest


def main(argv=None):
    cfg = parse_into(IngestConfig(), argv, description=__doc__)
    if not cfg.source_dir or not cfg.out_dir:
        raise SystemExit("--source-dir and --out-dir are required")
    n = ingest(cfg.source_dir, cfg.out_dir, subjects=cfg.subjects)
    print(f"ingested {n} (sequence, camera) cells -> {cfg.out_dir}")
    return n


if __name__ == "__main__":
    main()
