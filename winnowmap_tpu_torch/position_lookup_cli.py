"""position-lookup equivalent: k-mer position painting against a reference.

Reference ext/meryl/src/meryl-lookup/position-lookup.C: loads a meryl DB
as an exact lookup, records the positions of every DB k-mer in a reference
FASTA (loadPositions, kmers-exact.C:687-780; each k-mer's slot count is
its DB value), then streams query sequences in batches (4096 sequences /
16 MB) and reports:
  -hpq: per query "nPer\\ttCov\\tlen\\tident" where tCov counts query
        k-mers present in the DB and nPer sums their DB values.
  -mpb: per reference position (sequence IDs collapsed, as in the
        reference painting arrays) the number of query k-mer hits mapping
        there, "pos count" lines ascending.
  -qpb: same but counting distinct (k-mer, query) pairs per batch.

The port of winnowmap_tpu/position_lookup_cli.py: it reads meryl v1
databases (kcount/meryldb.py) and counts nothing, so it launches no kernel;
the databases it reads come from the port's meryl_cli count, which counts
through KC on the card.
"""
from __future__ import annotations

import sys

import numpy as np

from .kcount import MERYL_CODE


def _kmers_positions(seq: bytes, k: int):
    """(canonical kmer codes u64, start positions) for valid windows."""
    codes = MERYL_CODE[np.frombuffer(seq, dtype=np.uint8)]
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
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
    return canon[ok], np.flatnonzero(ok).astype(np.int64)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    db = ref = None
    hpq = mpb = qpb = None
    inputs = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-m":
            i += 1
            db = argv[i]
        elif a == "-s":
            i += 1
            ref = argv[i]
        elif a == "-hpq":
            i += 1
            hpq = argv[i]
        elif a == "-mpb":
            i += 1
            mpb = argv[i]
        elif a == "-qpb":
            i += 1
            qpb = argv[i]
        else:
            inputs.append(a)
        i += 1
    if db is None or ref is None:
        print("usage: position-lookup -m <db.meryl> -s <ref.fasta> "
              "[-hpq f] [-mpb f] [-qpb f] <queries.fasta> ...",
              file=sys.stderr)
        return 1

    from .io.fastx import read_all
    from .kcount import KmerCounts

    kc = KmerCounts.load(db)
    k = kc.k
    db_kmers = kc.kmers          # sorted unique
    db_vals = kc.counts.astype(np.int64)

    # reference scan: per-DB-kmer position lists, scan order, capped at the
    # DB value (the reference writer allots exactly value slots per kmer)
    idx_parts, pos_parts = [], []
    for rec in read_all(ref):
        km, pos = _kmers_positions(rec.seq, k)
        loc = np.searchsorted(db_kmers, km)
        loc_c = np.minimum(loc, max(len(db_kmers) - 1, 0))
        hit = (len(db_kmers) > 0) & (db_kmers[loc_c] == km)
        idx_parts.append(loc_c[hit].astype(np.int64))
        pos_parts.append(pos[hit])
    ref_idx = np.concatenate(idx_parts) if idx_parts else np.zeros(0, np.int64)
    ref_pos = np.concatenate(pos_parts) if pos_parts else np.zeros(0, np.int64)
    order = np.argsort(ref_idx, kind="stable")  # keeps scan order per kmer
    ref_idx, ref_pos = ref_idx[order], ref_pos[order]
    starts = np.searchsorted(ref_idx, np.arange(len(db_kmers) + 1))
    # cap each kmer's list at its DB value
    counts_found = starts[1:] - starts[:-1]
    nmax = np.minimum(counts_found, db_vals)
    keep = np.zeros(len(ref_idx), bool)
    for ki in np.flatnonzero(counts_found > 0):
        keep[starts[ki]:starts[ki] + nmax[ki]] = True
    ref_pos = ref_pos[keep]
    pstart = np.zeros(len(db_kmers) + 1, np.int64)
    np.cumsum(nmax, out=pstart[1:])

    max_pos = int(ref_pos.max()) + 1 if len(ref_pos) else 1
    n_qmer = np.zeros(max_pos, np.int64)
    n_qseq = np.zeros(max_pos, np.int64)

    f_hpq = open(hpq, "w") if hpq else None

    def paint(idxs, weights, acc):
        """acc[pos] += weight for every ref position of each kmer idx."""
        for ki, w in zip(idxs.tolist(), weights.tolist()):
            ps = ref_pos[pstart[ki]:pstart[ki + 1]]
            np.add.at(acc, ps, w)

    # query batches: 4096 sequences / 16 MB, mirroring loadBatch
    recs = []
    for path in inputs:
        recs.extend(read_all(path))
    bi = 0
    while bi < len(recs):
        bj, nb = bi, 0
        while bj < len(recs) and (bj - bi) < 4 * 1024 and nb < 16 * 1048576:
            nb += len(recs[bj].seq)
            bj += 1
        batch = recs[bi:bj]
        hit_idx_all, hit_qid_all = [], []
        for qi, rec in enumerate(batch):
            km, _ = _kmers_positions(rec.seq, k)
            loc = np.searchsorted(db_kmers, km)
            loc_c = np.minimum(loc, max(len(db_kmers) - 1, 0))
            hit = (len(db_kmers) > 0) & (db_kmers[loc_c] == km)
            hidx = loc_c[hit]
            hit_idx_all.append(hidx)
            hit_qid_all.append(np.full(len(hidx), qi, np.int64))
            if f_hpq is not None:
                t_cov = int(hit.sum())
                n_per = int(db_vals[hidx].sum())
                ident = rec.name.split()[0] if rec.name else ""
                f_hpq.write(f"{n_per}\t{t_cov}\t{len(rec.seq)}\t{ident}\n")
        hit_idx = (np.concatenate(hit_idx_all) if hit_idx_all
                   else np.zeros(0, np.int64))
        hit_qid = (np.concatenate(hit_qid_all) if hit_qid_all
                   else np.zeros(0, np.int64))
        if mpb and len(hit_idx):
            per_kmer = np.bincount(hit_idx, minlength=len(db_kmers))
            nz = np.flatnonzero(per_kmer)
            paint(nz, per_kmer[nz], n_qmer)
        if qpb and len(hit_idx):
            pairs = np.unique(np.stack([hit_idx, hit_qid]), axis=1)
            per_kmer = np.bincount(pairs[0], minlength=len(db_kmers))
            nz = np.flatnonzero(per_kmer)
            paint(nz, per_kmer[nz], n_qseq)
        bi = bj
    if f_hpq is not None:
        f_hpq.close()

    if mpb:
        with open(mpb, "w") as f:
            for p in np.flatnonzero(n_qmer):
                f.write(f"{p} {n_qmer[p]}\n")
    if qpb:
        with open(qpb, "w") as f:
            for p in np.flatnonzero(n_qseq):
                f.write(f"{p} {n_qseq[p]}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
