"""CLI: ResNet-50 feature extraction on one GPU (counterpart of
h36x/cli/extract.py).

    python -m h36x_torch.cli.extract --root INGESTED --out STORE \\
        [--engine opt] [--device cpu] [h36x's other extraction flags]

writes an h36x feature store (shard_*.h36x + index.json) that both
packages read. On the card `--engine opt` runs the folded ResNet-50 whose
13 stride-1 blocks each launch the fused bottleneck kernel; the default
engine, 'flax', is the plain module. `--device cpu` runs the plain PyTorch
path on the CPU. Decoding the mp4 tree needs OpenCV.
"""

import argparse

from h36x_torch.config import ExtractConfig, add_fields, apply_namespace
from h36x_torch.extract.pipeline import run_extract
from h36x_torch.utils.runtime import resolve_device


def main(argv=None):
    """Returns run_extract's summary."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_fields(p, ExtractConfig())
    p.add_argument("--device", default=None,
                   help="torch device to extract on (default: cuda; 'cpu' runs "
                        "the plain PyTorch path)")
    ns = p.parse_args(argv)
    cfg = apply_namespace(ExtractConfig(), ns, skip=("device",))
    if not cfg.root or not cfg.out:
        raise SystemExit("--root and --out are required")
    summary = run_extract(cfg, device=resolve_device(ns.device))
    if cfg.verify_after:
        from h36x_torch.data.shards import verify_store

        rep = verify_store(cfg.out)
        if rep["errors"]:
            for e in rep["errors"][:10]:
                print(f"  - {e}")
            raise SystemExit(
                f"--verify-after: the store failed its read-back CRC scan "
                f"({len(rep['errors'])} error(s)) — do not train on it")
        print(f"[verify-after] {rep['n_shards']} shards, {rep['rows']} rows, "
              f"{rep['arrays_checked']} arrays CRC-verified")
    return summary


if __name__ == "__main__":
    main()
