"""Filter a PAF file down to a set of read ids.

Equivalent of the reference's scripts/extractSelectedReads.R (which exists
because `grep -f` is too slow for big id lists): stream the PAF once,
keeping lines whose first column is in the id set — O(1) per line via a
hash set instead of R's %in%.  The port of
winnowmap_tpu/tools/extract_selected_reads.py: text in, text out, no
device.

Usage:
  python -m winnowmap_tpu_torch.tools.extract_selected_reads \
      [--paf output.paf] [--ids readids.txt] [--out filtered.paf]
"""
from __future__ import annotations

import argparse
import sys


def extract(paf_path: str, ids_path: str, out_path: str) -> int:
    with open(ids_path) as f:
        # R read.table takes the first whitespace column
        want = {ln.split()[0] for ln in f if ln.strip()}
    kept = 0
    with open(paf_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            if line.split("\t", 1)[0] in want:
                fout.write(line)
                kept += 1
    return kept


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="extract_selected_reads", description=__doc__.splitlines()[0])
    ap.add_argument("--paf", default="output.paf")
    ap.add_argument("--ids", default="readids.repetitive.txt")
    ap.add_argument("--out", default="output.repetitive.paf")
    args = ap.parse_args(argv)
    kept = extract(args.paf, args.ids, args.out)
    print(f"[extract_selected_reads] kept {kept} mappings -> {args.out}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
