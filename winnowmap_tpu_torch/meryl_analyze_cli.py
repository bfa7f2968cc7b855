"""meryl-analyze equivalent: k-mer composition histograms over a DB.

Reference ext/meryl/src/meryl-analyze/meryl-analyze.C:
  -gc: per-k-mer G+C base count -> `<prefix>.GC.hist` with lines
       "score\\tvalue\\t#kmers" (score-major, value ascending).
  -ga: run-length purine/pyrimidine scores walked from the low bases
       (fscore sums mixed A/G runs, rscore mixed T/C runs, each flushed
       when the other class interrupts; meryl-analyze.C:224-295) ->
       `<prefix>.GA_TC.hist` (elementwise max), `.GA.hist`, `.TC.hist`.

The port of winnowmap_tpu/meryl_analyze_cli.py: it reads meryl v1 databases
(kcount/meryldb.py) and counts nothing, so it launches no kernel; the
databases it reads come from the port's meryl_cli count, which counts
through KC on the card.
"""
from __future__ import annotations

import sys
from collections import defaultdict

import numpy as np


def _write_hist(path: str, k: int, scores: np.ndarray, values: np.ndarray):
    hist: dict = defaultdict(lambda: defaultdict(int))
    for s, v in zip(scores.tolist(), values.tolist()):
        hist[s][v] += 1
    with open(path, "w") as f:
        for s in range(k + 1):
            if s in hist:
                for v in sorted(hist[s]):
                    f.write(f"{s}\t{v}\t{hist[s][v]}\n")


def _ga_scores(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(fscore, rscore) per kmer: codes is (n, k) low-base-first."""
    n = codes.shape[0]
    z = np.zeros(n, np.int64)
    fa, fg, rt, rc = z.copy(), z.copy(), z.copy(), z.copy()
    fscore, rscore = z.copy(), z.copy()
    for j in range(codes.shape[1]):
        c = codes[:, j]
        is_a, is_c = c == 0, c == 1
        is_t, is_g = c == 2, c == 3
        # A or G interrupts a T/C run; C or T interrupts an A/G run
        r_flush = (is_a | is_g) & (rt > 0) & (rc > 0)
        rscore += np.where(r_flush, rt + rc, 0)
        rt = np.where(is_a | is_g, 0, rt + is_t)
        rc = np.where(is_a | is_g, 0, rc + is_c)
        f_flush = (is_c | is_t) & (fa > 0) & (fg > 0)
        fscore += np.where(f_flush, fa + fg, 0)
        fa = np.where(is_c | is_t, 0, fa + is_a)
        fg = np.where(is_c | is_t, 0, fg + is_g)
    fscore += np.where((fa > 0) & (fg > 0), fa + fg, 0)
    rscore += np.where((rt > 0) & (rc > 0), rt + rc, 0)
    return fscore, rscore


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    db = prefix = None
    do_gc = do_ga = False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-mers":
            i += 1
            db = argv[i]
        elif a == "-prefix":
            i += 1
            prefix = argv[i]
        elif a == "-gc":
            do_gc = True
        elif a == "-ga":
            do_ga = True
        elif a == "-v":
            pass
        else:
            print(f"Unknown option '{a}'.", file=sys.stderr)
            return 1
        i += 1
    if db is None or prefix is None or not (do_gc or do_ga):
        print("usage: meryl-analyze -mers <meryldb> -prefix <prefix> "
              "(-ga | -gc)", file=sys.stderr)
        return 1

    from .kcount import KmerCounts

    kc = KmerCounts.load(db)
    k = kc.k
    # base codes low-first: codes[:, j] = bits 2j..2j+1 of the stored kmer
    codes = np.empty((len(kc.kmers), k), np.uint8)
    for j in range(k):
        codes[:, j] = ((kc.kmers >> np.uint64(2 * j)) & np.uint64(3))
    values = kc.counts

    if do_gc:
        score = ((codes == 1).sum(axis=1) + (codes == 3).sum(axis=1))
        _write_hist(f"{prefix}.GC.hist", k, score, values)
    if do_ga:
        fscore, rscore = _ga_scores(codes)
        _write_hist(f"{prefix}.GA_TC.hist", k, np.maximum(fscore, rscore),
                    values)
        _write_hist(f"{prefix}.GA.hist", k, fscore, values)
        _write_hist(f"{prefix}.TC.hist", k, rscore, values)
    print("Bye!", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
