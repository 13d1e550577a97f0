"""CLI: merge the part stores of a partitioned extraction into one store
(counterpart of h36x/cli/merge_shards.py).

N jobs each run `python -m h36x_torch.cli.extract --partition i/N --out
PARTS/part_i`; then

    python -m h36x_torch.cli.merge_shards --parts PARTS/part_* \\
        --out FEATURES [--keep-parts] [--verify]

renumbers the parts' shards into one store and concatenates their clip
indexes, reading no array (:func:`h36x_torch.data.shards.merge_stores`).
`--verify` first CRC-checks every part and refuses to merge a corrupt one.
"""

import argparse

from h36x_torch.data.shards import merge_stores, verify_store


def main(argv=None):
    """Returns the merged index."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parts", nargs="+", required=True,
                    help="part store directories, in partition order")
    ap.add_argument("--out", required=True, help="merged store directory")
    ap.add_argument("--keep-parts", action="store_true",
                    help="hard-link/copy shards instead of moving them")
    ap.add_argument("--verify", action="store_true",
                    help="CRC-verify every part before merging (a full read)")
    args = ap.parse_args(argv)

    if args.verify:
        for part in args.parts:
            rep = verify_store(part)
            if rep["errors"]:
                for e in rep["errors"][:10]:
                    print(f"  - {e}")
                raise SystemExit(f"part {part} failed integrity verification "
                                 f"({len(rep['errors'])} error(s)); not merging")
            print(f"  [ok] {part}: {rep['arrays_checked']} arrays CRC-verified, "
                  f"{rep['rows']} rows")

    idx = merge_stores(args.parts, args.out, move=not args.keep_parts)
    print(f"Merged {len(args.parts)} part stores -> {args.out}: "
          f"{idx['n_clips']} clips x {idx['n_variants']} variants in "
          f"{idx['n_shards']} shards")
    return idx


if __name__ == "__main__":
    main()
