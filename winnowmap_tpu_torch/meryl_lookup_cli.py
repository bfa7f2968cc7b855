"""meryl-lookup-compatible command line (reference
ext/meryl/src/meryl-lookup/meryl-lookup.C, existence.C, dump.C,
include-exclude.C).

Compares the k-mers of input sequences against k-mer databases produced by
the port's meryl-equivalent counter (winnowmap_tpu_torch.meryl_cli,
which counts through KC on the card), supporting the
reference report types: -existence, -include, -exclude, -bed, -bed-runs.
Window iteration matches the reference kmerIterator: a window containing a
non-ACGT base is skipped and iteration restarts after it.

The port of winnowmap_tpu/meryl_lookup_cli.py: it reads meryl v1 databases
(kcount/meryldb.py) and counts nothing, so it launches no kernel; the
databases it reads come from the port's meryl_cli count, which counts
through KC on the card.
"""
from __future__ import annotations

import sys

import numpy as np

from .kcount import KmerCounts
from .io.fastx import read_all

USAGE = """usage: meryl-lookup-torch <report-type> \\
         -sequence <input1.fasta> [-output <output1>] \\
         -mers <input1.db> [...]
  Report types: -existence | -include | -exclude | -bed | -bed-runs |
                -wig-count | -wig-depth"""


def _kmer_codes(seq: bytes, k: int):
    """Positions and canonical codes of all valid k-mer windows (reference
    kmerIterator semantics: a window containing a non-ACGT base is skipped).
    Uses the meryl 2-bit encoding (A=0,C=1,T=2,G=3, complement = code^2,
    reference kmers-tiny.H:86-87) via the kcount tables."""
    from .kcount import MERYL_CODE

    codes = MERYL_CODE[np.frombuffer(seq, np.uint8)]
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64)
    valid = codes != 255
    ok = np.ones(n, dtype=bool)
    fwd = np.zeros(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.uint64)
    c64 = codes.astype(np.uint64)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | c64[j:j + n]
        rev |= (c64[j:j + n] ^ np.uint64(2)) << np.uint64(2 * j)
        ok &= valid[j:j + n]
    canon = np.minimum(fwd, rev)
    pos = np.nonzero(ok)[0]
    return pos.astype(np.int64), canon[pos]


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(USAGE, file=sys.stderr)
        return 1
    mode = None
    seq_files: list[str] = []
    dbs: list[str] = []
    out_path = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-existence", "-include", "-exclude", "-bed", "-bed-runs",
                 "-wig-count", "-wig-depth"):
            mode = a[1:]
        elif a == "-sequence":
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                seq_files.append(argv[i])
                i += 1
            continue
        elif a == "-mers":
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                dbs.append(argv[i])
                i += 1
            continue
        elif a == "-output":
            i += 1
            out_path = argv[i]
        else:
            print(f"Unknown option '{a}'", file=sys.stderr)
            return 1
        i += 1
    if mode is None or not seq_files or not dbs:
        print(USAGE, file=sys.stderr)
        return 1

    kcs = [KmerCounts.load(p) for p in dbs]
    k = kcs[0].k
    out = open(out_path, "w") if out_path else sys.stdout

    for sf in seq_files:
        for rec in read_all(sf):
            pos, canon = _kmer_codes(rec.seq, k)
            founds = []
            for kc in kcs:
                km = kc.kmers
                idx = np.searchsorted(km, canon)
                idxc = np.minimum(idx, max(len(km) - 1, 0))
                f = (idx < len(km)) & (km[idxc] == canon) \
                    if len(km) else np.zeros(len(canon), bool)
                founds.append(f)
            if mode == "existence":
                cols = [rec.name, str(len(pos))]
                for kc, f in zip(kcs, founds):
                    cols += [str(kc.n_distinct), str(int(f.sum()))]
                out.write("\t".join(cols) + "\n")
            elif mode in ("include", "exclude"):
                n_found = int(founds[0].sum())
                keep = n_found > 0 if mode == "include" else n_found == 0
                if keep:
                    out.write(f">{rec.name} nKmers={n_found}\n")
                    out.write(rec.seq.decode() + "\n")
            elif mode == "wig-count":
                # reference dump.C:140-165,381-411: per-kmer summed DB
                # counts at 1-based start positions, zeros skipped
                out.write(f"variableStep chrom={rec.name}\n")
                if len(pos):
                    cnt = np.zeros(int(pos[-1]) + 1, np.int64)
                    for kc in kcs:
                        km = kc.kmers
                        idx = np.searchsorted(km, canon)
                        idxc = np.minimum(idx, max(len(km) - 1, 0))
                        f = (idx < len(km)) & (km[idxc] == canon) \
                            if len(km) else np.zeros(len(canon), bool)
                        cnt[pos[f]] += kc.counts[idxc[f]]
                    nz = np.nonzero(cnt)[0]
                    for p_ in nz.tolist():
                        out.write(f"{p_ + 1}\t{int(cnt[p_])}\n")
            elif mode == "wig-depth":
                # reference dump.C:221-243: kmer coverage depth via a
                # difference array over [start, start+k) of found kmers
                out.write(f"variableStep chrom={rec.name}\n")
                hit = np.zeros(len(pos), bool)
                for f in founds:
                    hit |= f
                ph = pos[hit]
                if len(ph):
                    maxp = int(ph[-1]) + k
                    diff = np.zeros(maxp + 1, np.int64)
                    np.add.at(diff, ph, 1)
                    np.add.at(diff, ph + k, -1)
                    depth = np.cumsum(diff)[:maxp]
                    nz = np.nonzero(depth)[0]
                    for p_ in nz.tolist():
                        out.write(f"{p_ + 1}\t{int(depth[p_])}\n")
            elif mode in ("bed", "bed-runs"):
                hit = np.zeros(len(pos), bool)
                for f in founds:
                    hit |= f
                p = pos[hit]
                if mode == "bed":
                    for s in p.tolist():
                        out.write(f"{rec.name}\t{s}\t{s + k}\n")
                else:
                    # reference run semantics (dump.C:329-353): a run is a
                    # maximal stretch of *consecutive* kmer start positions;
                    # the record ends at (first unset position) + k, so
                    # adjacent runs may overlap in the output
                    if len(p):
                        breaks = np.nonzero(np.diff(p) > 1)[0]
                        starts = np.concatenate([[0], breaks + 1])
                        ends = np.concatenate([breaks, [len(p) - 1]])
                        for a, b in zip(starts.tolist(), ends.tolist()):
                            out.write(
                                f"{rec.name}\t{int(p[a])}\t"
                                f"{int(p[b]) + 1 + k}\n")
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
