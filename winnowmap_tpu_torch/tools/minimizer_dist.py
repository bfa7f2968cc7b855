"""Minimizer-density profile across a reference sequence.

Equivalent of the reference's scripts/minimizerDist.R: read a minimizer
dump (rid, pos, key — the format of the reference's
WRITE_MINIMIZERS_TO_FILE hook, reference src/sketch.c:12-17, and of our
`--dump-minimizers`), optionally drop minimizers whose key occurs more
than MAX_OCC times, then estimate the positional density of the surviving
minimizers on one sequence with a gaussian kernel (R `density(x, bw=500)`
semantics: sd = bw, 512-point grid over [min - 3*bw, max + 3*bw]).

Improvements over the R script: the dump can be produced in-process from a
FASTA (+ optional -W down-weight list) instead of recompiling the mapper,
and the density lands in a plottable TSV (plus a PDF when matplotlib is
installed) instead of requiring an R stack.

The port of winnowmap_tpu/tools/minimizer_dist.py: --fasta sketches as
the port's index build does (index/build.sketch_genome): a genome of
DEVICE_SKETCH_MIN_BP (1 Mbp) or more through S1 on the card, in one launch
a SKETCH_MAX_CODES of records, a smaller one with the native sketch;
--device cpu runs S1's plain version instead of the card.

Usage:
  python -m winnowmap_tpu_torch.tools.minimizer_dist [--input minimizers.txt]
      [--fasta ref.fa [-W rep.txt] [-k 15] [-w 50]]
      [--max-occ N] [--rid R] [--bw 500] [--out density.tsv] [--pdf out.pdf]
      [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..index.build import (DEVICE_SKETCH_MIN_BP, genome_codes,
                           load_weight_set, sketch_genome)
from ..io.fastx import read_all


def sketch_dump(fasta: str, k: int = 15, w: int = 50, wfile: str | None = None,
                hpc: bool = False, device=None,
                sketch_min_bp: int | None = DEVICE_SKETCH_MIN_BP
                ) -> np.ndarray:
    """(n, 3) int64 array of (rid, pos, key) rows -- the dump the reference
    emits with WRITE_MINIMIZERS_TO_FILE=1 (sketch.c:130-218), computed with
    the port's sketch instead of a recompile: S1 on `device` (None: the
    card) for a genome of sketch_min_bp or more bases, the native sketch
    below that or with sketch_min_bp None (index/build.sketch_genome)."""
    records = read_all(fasta)
    wset = load_weight_set(wfile, k)
    seqs: list = []
    codes = genome_codes(records, seqs)
    xs, ys = sketch_genome(records, codes, seqs, w, k, hpc, wset, None,
                           device, sketch_min_bp)
    rows = []
    for x, y in zip(xs, ys):
        rid_a = (y >> np.uint64(32)).astype(np.int64)
        pos_a = ((y & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
        key_a = (x >> np.uint64(8)).astype(np.int64)
        rows.append(np.stack([rid_a, pos_a, key_a], axis=1))
    return (np.concatenate(rows, axis=0) if rows
            else np.zeros((0, 3), np.int64))


def filter_max_occ(dump: np.ndarray, max_occ: int) -> np.ndarray:
    """Keep rows whose key occurs <= max_occ times across the WHOLE dump
    (the R script counts occurrences before sub-setting to one rid)."""
    if max_occ < 0:
        return dump
    keys, inv, counts = np.unique(dump[:, 2], return_inverse=True,
                                  return_counts=True)
    return dump[counts[inv] <= max_occ]


def density_grid(pos: np.ndarray, bw: float = 500.0,
                 n_grid: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian KDE matching R density(x, bw=<sd>): grid of n_grid points
    over [min - 3*bw, max + 3*bw], kernel sd = bw, integrates to 1."""
    pos = np.asarray(pos, np.float64)
    if pos.size == 0:
        raise SystemExit("no minimizers to profile (empty selection)")
    lo, hi = pos.min() - 3 * bw, pos.max() + 3 * bw
    grid = np.linspace(lo, hi, n_grid)
    # chunk the pairwise kernel evaluation to bound memory
    dens = np.zeros(n_grid)
    for i in range(0, len(pos), 65536):
        chunk = pos[i:i + 65536]
        z = (grid[:, None] - chunk[None, :]) / bw
        dens += np.exp(-0.5 * z * z).sum(axis=1)
    dens /= len(pos) * bw * np.sqrt(2 * np.pi)
    return grid, dens


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(
        prog="minimizer_dist", description=__doc__.splitlines()[0])
    ap.add_argument("--input", default=None,
                    help="minimizer dump (rid\\tpos\\tkey per line)")
    ap.add_argument("--fasta", default=None,
                    help="compute the dump from this FASTA instead")
    ap.add_argument("-W", dest="wfile", default=None,
                    help="down-weight k-mer list for --fasta mode")
    ap.add_argument("-k", type=int, default=15)
    ap.add_argument("-w", type=int, default=50)
    ap.add_argument("--max-occ", type=int, default=-1,
                    help="drop keys with more than this many occurrences "
                         "(-1 = keep all)")
    ap.add_argument("--rid", type=int, default=0,
                    help="0-based target sequence id to profile")
    ap.add_argument("--bw", type=float, default=500.0)
    ap.add_argument("--out", default="density.tsv")
    ap.add_argument("--pdf", default=None,
                    help="also render a PDF plot (needs matplotlib)")
    ap.add_argument("--device", default=device,
                    help="where --fasta sketches a genome of 1 Mbp or more: "
                         "cuda (the default) or cpu (S1's plain version)")
    args = ap.parse_args(argv)

    if args.fasta:
        dump = sketch_dump(args.fasta, args.k, args.w, args.wfile,
                           device=args.device)
    elif args.input:
        dump = np.loadtxt(args.input, dtype=np.int64, ndmin=2)
        if dump.size == 0:
            dump = np.zeros((0, 3), np.int64)
    else:
        ap.error("one of --input / --fasta is required")

    dump = filter_max_occ(dump, args.max_occ)
    sel = dump[dump[:, 0] == args.rid]
    grid, dens = density_grid(sel[:, 1], bw=args.bw)
    with open(args.out, "w") as f:
        f.write("# minimizer positional density rid=%d n=%d bw=%g\n"
                % (args.rid, len(sel), args.bw))
        for g, d in zip(grid, dens):
            f.write(f"{g:.2f}\t{d:.6e}\n")
    print(f"[minimizer_dist] {len(sel)} minimizers on rid {args.rid} -> "
          f"{args.out}", file=sys.stderr)
    if args.pdf:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, axp = plt.subplots(figsize=(6, 4))
            axp.plot(grid, dens)
            axp.set_title("Minimizer density across sequence %d" % args.rid)
            axp.set_xlabel("position")
            axp.set_ylabel("density")
            fig.savefig(args.pdf)
        except ImportError:
            print("[minimizer_dist] matplotlib not installed; TSV only",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
