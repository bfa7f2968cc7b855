"""The plain reference that judges a mapping run's SAM output.

It reads only the benchmark's own inputs (the genome's codes, each read as
generated and where it came from, the planted introns) and the program's
SAM text, and works out again from the two sequences what each record
claims.  It imports numpy and nothing of the program.

Numbers (`judge`):

- record_faults: records whose CIGAR does not span their read (clips
  included), whose reference stretch leaves the chromosome, whose SEQ is
  not the read (or its aligned part, for hard clips), or whose NM:i or
  ms:i differ from what the read, the reference and the CIGAR give under
  the stated scoring: NM = mismatches + inserted + deleted bases (N ops
  skip), ms = the largest running score of the path, a match +a, a
  mismatch -b, a gap of length l -(q + e*l), floored at 0 after each step
  (the reference mapper's mm_update_extra).
- origin_miss_pct: of the sampled reads of unique origin, the share whose
  primary record is unmapped or misses the read's chromosome, strand or
  genome interval.
- clipped_pct: of those reads' bases, the share that no primary or
  supplementary record aligns; primary_clipped_pct: the share outside
  the primary record's aligned stretch (all of an unmapped read's).
- intron_miss_pct: of the N ops of the sampled reads' primary and
  supplementary records, the share that is not a planted intron, start
  and end exact.
- dp_score_deficit_pct: the extension DP and its traceback held to the
  best path.  Windows of about `bp` read bases (`per_read` of them, spread
  over each sampled read's primary record, none across an N op or a long
  deletion) are cut between two bases the record's path aligns; in each,
  this module's own DP (full, unbanded, global between the two points)
  finds the best score under the stated scoring (a match +a, a mismatch
  -b, a gap of length l -min(q + e*l, q2 + e2*l), or -(q + e*l) where the
  configuration's gaps are single-affine), and the record's path through
  the window is scored the same way.  The number is the best scores'
  excess over the path's, summed over windows, as a share of the best
  scores.  A DP that finds the best path under the stated scoring reads
  about 0; one run with another gap cost or score, or in a band too
  narrow for its gaps, reads above.
"""
from __future__ import annotations

import numpy as np

_OPS = {c: i for i, c in enumerate("MIDNSHP=X")}
_QCONS = np.array([1, 1, 0, 0, 1, 1, 0, 1, 1], bool)
_TCONS = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], bool)
_ALIGNED = np.array([1, 0, 0, 0, 0, 0, 0, 1, 1], bool)  # M = X
_NT4 = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _NT4[_c] = _i
    _NT4[_c + 32] = _i


def codes_of(seq: bytes) -> np.ndarray:
    return _NT4[np.frombuffer(seq, np.uint8)]


def revcomp(codes: np.ndarray) -> np.ndarray:
    out = codes[::-1].copy()
    m = out < 4
    out[m] = 3 - out[m]
    return out


def parse_cigar(cigar: str):
    """(op codes, lengths) of a CIGAR string."""
    ops, lens, n = [], [], 0
    for ch in cigar:
        if "0" <= ch <= "9":
            n = n * 10 + ord(ch) - 48
        else:
            ops.append(_OPS[ch])
            lens.append(n)
            n = 0
    return np.array(ops, np.int64), np.array(lens, np.int64)


def _ragged(lens):
    owner = np.repeat(np.arange(len(lens)), lens)
    starts = np.cumsum(lens) - lens
    return owner, np.arange(int(lens.sum()), dtype=np.int64) - starts[owner]


def walk(qseq, tseq, t0: int, ops, lens, sc: dict):
    """(mismatches, inserted, deleted, ms, introns) of one record's path:
    qseq the read as aligned (clips included), tseq the chromosome, t0 the
    record's 0-based start."""
    qc = np.where(_QCONS[ops], lens, 0)
    tc = np.where(_TCONS[ops], lens, 0)
    qoff = np.cumsum(qc) - qc
    toff = t0 + np.cumsum(tc) - tc
    m = _ALIGNED[ops]
    owner, off = _ragged(lens[m])
    eq = qseq[qoff[m][owner] + off] == tseq[toff[m][owner] + off]
    ins, dele = ops == 1, ops == 2
    # the score walk: one step a matched base, one a gap
    steps = np.where(m, lens, np.where(ins | dele, 1, 0))
    at = np.cumsum(steps) - steps
    vals = np.zeros(int(steps.sum()), np.int64)
    vals[at[m][owner] + off] = np.where(eq, sc["a"], -sc["b"])
    gap = ins | dele
    vals[at[gap]] = -(sc["q"] + sc["e"] * lens[gap])
    p = np.cumsum(vals)
    run = p - np.minimum(np.minimum.accumulate(p), 0)
    ms = int(max(run.max(initial=0), 0))
    nskip = ops == 3
    introns = np.stack([toff[nskip], toff[nskip] + lens[nskip]], 1)
    return (int((~eq).sum()), int(lens[ins].sum()), int(lens[dele].sum()),
            ms, introns)


def gap_cost(lens, sc: dict):
    """The cost of gaps of these lengths: min(q + e*l, q2 + e2*l), or
    q + e*l where the scoring states no q2."""
    lens = np.asarray(lens, np.int64)
    c = sc["q"] + sc["e"] * lens
    if "q2" in sc:
        c = np.minimum(c, sc["q2"] + sc["e2"] * lens)
    return c


NEG = -(1 << 40)


def best_scores(qsegs: list, tsegs: list, sc: dict) -> np.ndarray:
    """The best global alignment score of each (query, target) pair of code
    arrays, end to end, under the stated scoring (Gotoh's recurrences a
    query base at a time, all pairs at once; the gaps along the target by
    a running maximum)."""
    n = len(qsegs)
    lq = np.array([len(x) for x in qsegs], np.int64)
    lt = np.array([len(x) for x in tsegs], np.int64)
    Lq, Lt = int(lq.max(initial=0)), int(lt.max(initial=0))
    Q = np.full((n, Lq), 5, np.int64)
    T = np.full((n, Lt), 6, np.int64)
    for i, (x, y) in enumerate(zip(qsegs, tsegs)):
        Q[i, :len(x)] = x
        T[i, :len(y)] = y
    costs = [(sc["q"], sc["e"])]
    if "q2" in sc:
        costs.append((sc["q2"], sc["e2"]))
    j = np.arange(Lt + 1, dtype=np.int64)
    H = np.broadcast_to(-gap_cost(j, sc), (n, Lt + 1)).copy()
    H[:, 0] = 0
    F = [np.full((n, Lt + 1), NEG, np.int64) for _ in costs]
    out = np.where(lq == 0, H[np.arange(n), lt], NEG)
    rows = np.arange(n)
    for i in range(1, Lq + 1):
        s = np.where(Q[:, i - 1:i] == T, sc["a"], -sc["b"])
        Ht = np.full((n, Lt + 1), NEG, np.int64)
        Ht[:, 1:] = H[:, :-1] + s
        for k, (q, e) in enumerate(costs):
            F[k] = np.maximum(F[k] - e, H - q - e)
            Ht = np.maximum(Ht, F[k])
        H = Ht.copy()
        for q, e in costs:
            run = np.maximum.accumulate(Ht + e * j, axis=1)
            H[:, 1:] = np.maximum(H[:, 1:], run[:, :-1] - q - e * j[1:])
        done = lq == i
        out[done] = H[rows[done], lt[done]]
    return out


def path_windows(qseq, tseq, t0: int, ops, lens, sc: dict, bp: int,
                 per_read: int) -> list:
    """Up to per_read windows of one record's path: (query codes, target
    codes, the path's score through them).  Each runs from just after an
    aligned base to just after the first aligned base at least bp read
    bases on; one that holds an N op or a target stretch over 2 * bp + 50
    is left out."""
    qc = np.where(_QCONS[ops], lens, 0)
    tc = np.where(_TCONS[ops], lens, 0)
    qoff = np.cumsum(qc) - qc
    toff = t0 + np.cumsum(tc) - tc
    m = _ALIGNED[ops]
    owner, off = _ragged(lens[m])
    qa = qoff[m][owner] + off
    ta = toff[m][owner] + off
    gap = (ops == 1) | (ops == 2)
    steps = np.where(m, lens, np.where(gap, 1, 0))
    at = np.cumsum(steps) - steps
    vals = np.zeros(int(steps.sum()), np.int64)
    step = at[m][owner] + off
    vals[step] = np.where(qseq[qa] == tseq[ta], sc["a"], -sc["b"])
    vals[at[gap]] = -gap_cost(lens[gap], sc)
    cum = np.cumsum(vals)
    n_at = at[ops == 3]
    out = []
    if len(qa) < 2:
        return out
    span = qa[-1] - qa[0]
    for k in range(per_read):
        want = qa[0] + (2 * k + 1) * span // (2 * per_read) - bp // 2
        u = int(np.searchsorted(qa, want))
        v = int(np.searchsorted(qa, qa[min(u, len(qa) - 1)] + bp))
        if v >= len(qa) or u >= v:
            continue
        su, sv = step[u], step[v]
        if ((n_at > su) & (n_at <= sv)).any() or \
                ta[v] - ta[u] > 2 * bp + 50:
            continue
        out.append((qseq[qa[u] + 1:qa[v] + 1], tseq[ta[u] + 1:ta[v] + 1],
                    int(cum[sv] - cum[su])))
    return out


def _tags(fields):
    out = {}
    for f in fields:
        k, t, v = f.split(":", 2)
        if t == "i":
            out[k] = int(v)
    return out


class Judge:
    """Accumulates the numbers over records, then reports them."""

    def __init__(self, names, chroms, scoring: dict, planted=None,
                 dp=None):
        self.rid = {n: i for i, n in enumerate(names)}
        self.chroms = chroms
        self.sc = scoring
        self.planted = planted  # set of (chrom, start, end)
        self.records = self.record_faults = 0
        self.origin_reads = self.origin_miss = 0
        self.bases = self.clipped = self.primary_clipped = 0
        self.n_ops = self.n_miss = 0
        self.dp = dp  # {"bp", "per_read", "gaps"} or None
        self.windows = []  # (query codes, target codes, path score)
        self.faults = []  # a few (qname, why) for the log

    def _fault(self, qname, why):
        self.record_faults += 1
        if len(self.faults) < 8:
            self.faults.append((qname, why))

    def record(self, f, read_codes):
        """Judge one mapped record (SAM fields); returns (forward-strand
        aligned query interval, introns) or None when it is faulty; a
        primary record's path windows are kept for the DP check."""
        self.records += 1
        qname, flag = f[0], int(f[1])
        ops, lens = parse_cigar(f[5])
        n = len(read_codes)
        if int(lens[_QCONS[ops]].sum()) != n:
            self._fault(qname, "CIGAR does not span the read")
            return None
        rev = bool(flag & 16)
        q = revcomp(read_codes) if rev else read_codes
        hard = np.where(ops == 5, lens, 0)
        lead = int(lens[0]) if ops[0] in (4, 5) else 0
        trail = int(lens[-1]) if ops[-1] in (4, 5) else 0
        if f[9] != "*":
            want = q[int(hard[0]):n - int(hard[-1])]
            if not np.array_equal(codes_of(f[9].encode()), want):
                self._fault(qname, "SEQ is not the read")
                return None
        ci = self.rid.get(f[2])
        t0 = int(f[3]) - 1
        if ci is None or t0 < 0 or t0 + int(lens[_TCONS[ops]].sum()) > \
                len(self.chroms[ci]):
            self._fault(qname, "reference stretch outside the chromosome")
            return None
        mis, ins, dele, ms, introns = walk(q, self.chroms[ci], t0, ops,
                                           lens, self.sc)
        tags = _tags(f[11:])
        if tags.get("NM") != mis + ins + dele:
            self._fault(qname, f"NM {tags.get('NM')} != {mis + ins + dele}")
            return None
        if tags.get("ms") != ms:
            self._fault(qname, f"ms {tags.get('ms')} != {ms}")
            return None
        if self.dp and not flag & 0x900:
            self.windows += path_windows(q, self.chroms[ci], t0, ops, lens,
                                         self.dp_scoring(),
                                         self.dp["bp"], self.dp["per_read"])
        st, en = lead, n - trail
        if rev:
            st, en = n - en, n - st
        return (st, en), [(ci, int(a), int(b)) for a, b in introns]

    def dp_scoring(self) -> dict:
        """The stated scoring as the DP check reads it: q2, e2 only where
        the configuration's gaps are dual-affine."""
        keys = ("a", "b", "q", "e") + (("q2", "e2")
                                       if self.dp["gaps"] == "dual" else ())
        return {k: self.sc[k] for k in keys}

    def read(self, lines, seq: bytes, origin):
        """Judge every record of one read.  origin: (chrom, start, end,
        rev, unique)."""
        codes = codes_of(seq)
        cover, primary, pspan = [], None, 0
        for f in lines:
            flag = int(f[1])
            if flag & 4:
                if not flag & 0x900:
                    primary = ("unmapped",)
                continue
            r = self.record(f, codes)
            if r is None:
                continue
            (st, en), introns = r
            if not flag & 0x100:
                cover.append((st, en))
                if self.planted is not None:
                    self.n_ops += len(introns)
                    self.n_miss += sum(i not in self.planted
                                       for i in introns)
            if not flag & 0x900:
                pspan = en - st
                primary = (self.rid.get(f[2]), bool(flag & 16),
                           int(f[3]) - 1,
                           int(f[3]) - 1 + int(sum(
                               ln for op, ln in zip(*parse_cigar(f[5]))
                               if _TCONS[op])))
        chrom, o_st, o_en, o_rev, unique = origin
        if not unique:
            return
        self.origin_reads += 1
        if (primary is None or primary[0] != chrom or primary[1] != o_rev
                or primary[3] <= o_st or primary[2] >= o_en):
            self.origin_miss += 1
        n = len(codes)
        covered = np.zeros(n + 1, np.int64)
        for st, en in cover:
            covered[st] += 1
            covered[en] -= 1
        self.bases += n
        self.clipped += int((np.cumsum(covered)[:n] == 0).sum())
        self.primary_clipped += n - pspan

    def numbers(self) -> dict:
        def pct(a, b):
            return 100.0 * a / b if b else 0.0
        out = {"record_faults": self.record_faults,
               "origin_miss_pct": pct(self.origin_miss, self.origin_reads),
               "clipped_pct": pct(self.clipped, self.bases),
               "primary_clipped_pct": pct(self.primary_clipped, self.bases)}
        if self.dp:
            best = best_scores([w[0] for w in self.windows],
                               [w[1] for w in self.windows],
                               self.dp_scoring())
            path = np.array([w[2] for w in self.windows], np.int64)
            out["dp_windows"] = len(path)
            out["dp_score_deficit_pct"] = pct(int((best - path).sum()),
                                              int(best.sum()))
        if self.planted is not None:
            out["intron_miss_pct"] = pct(self.n_miss, self.n_ops)
        return out


def judge(sam_lines, reads: dict, names, chroms, scoring: dict,
          planted=None, dp=None) -> tuple[dict, Judge]:
    """Judge the SAM lines (already split on tabs) of the reads in `reads`
    (qname -> (seq bytes, origin)); every read in `reads` must have
    records.  dp: the DP check's windows ({"bp", "per_read", "gaps"}), or
    None for no DP check.  Returns (numbers, the Judge)."""
    by_read: dict = {}
    for f in sam_lines:
        by_read.setdefault(f[0], []).append(f)
    j = Judge(names, chroms, scoring, planted, dp)
    for qname, (seq, origin) in reads.items():
        lines = by_read.get(qname, [])
        if not lines:
            j._fault(qname, "no record")
            continue
        j.read(lines, seq, origin)
    return j.numbers(), j
