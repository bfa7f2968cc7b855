"""meryl-equivalent k-mer counting (reference ext/meryl), for PyTorch and
CUDA.

Counterpart of winnowmap_tpu/kcount: counting is sort-based -- 2-bit pack,
canonicalize, sort, run-length encode -- in place of meryl's prefix-bucketed
bit-packed counting arrays and thread pipeline (reference
ext/meryl/src/meryl/merylOp-countThreads.C).  count_kmers streams the codes
through blocks, each counted on the card by KC (kcount/device.py,
csrc/kcount.cu), and merges the blocks' sorted runs on the host.  The
counted set, its filters, set algebra and persistence are numpy, copied
from the JAX package.

Encoding parity: meryl packs bases as (ch>>1)&3 (A=0,C=1,T=2,G=3) with
complement = code^2 (reference kmers-tiny.H:86-87), and its canonical k-mer
is min(fwd, rev) under *that* ordering; output order is ascending code.
We reproduce both so `print` output is byte-identical.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

# meryl base encoding table: (ch>>1)&3 for ACGT, 255 for anything else
MERYL_CODE = np.full(256, 255, dtype=np.uint8)
for _c in b"ACGTacgt":
    MERYL_CODE[_c] = (_c >> 1) & 3
_DECODE = {0: "A", 1: "C", 2: "T", 3: "G"}
MERYL_DECODE = np.frombuffer(
    bytes(ord(_DECODE[i]) for i in range(4)), dtype=np.uint8
)


def seq_to_kmers(seq: bytes, k: int,
                 direction: str = "canonical") -> np.ndarray:
    """All valid k-mer codes of one sequence (uint64): canonical
    min(fwd, revcomp) (reference merylOp-countThreads.C:246), forward-only
    (opCountForward) or reverse-complement-only (opCountReverse)."""
    codes = MERYL_CODE[np.frombuffer(seq, dtype=np.uint8)]
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    valid = codes != 255
    ok = np.ones(n, dtype=bool)
    fwd = np.zeros(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.uint64)
    c64 = codes.astype(np.uint64)
    need_f = direction != "reverse"
    need_r = direction != "forward"
    for j in range(k):
        if need_f:
            fwd = (fwd << np.uint64(2)) | c64[j : j + n]
        if need_r:
            rev |= ((c64[j : j + n] ^ np.uint64(2)) << np.uint64(2 * j))
        ok &= valid[j : j + n]
    if direction == "forward":
        return fwd[ok]
    if direction == "reverse":
        return rev[ok]
    canon = np.minimum(fwd, rev)
    return canon[ok]


@dataclass
class KmerCounts:
    """Counted k-mer set: sorted unique canonical codes + counts."""

    k: int
    kmers: np.ndarray  # uint64, ascending
    counts: np.ndarray  # int64

    @property
    def n_distinct(self) -> int:
        return len(self.kmers)

    @property
    def n_total(self) -> int:
        return int(self.counts.sum())

    def histogram(self) -> tuple[np.ndarray, np.ndarray]:
        """(count value ascending, #distinct kmers with that count)."""
        vals, occ = np.unique(self.counts, return_counts=True)
        return vals, occ

    def threshold_distinct(self, frac: float) -> int:
        """Count threshold covering `frac` of distinct k-mers
        (reference merylOp-nextMer.C:103-115)."""
        vals, occ = self.histogram()
        target = int(frac * self.n_distinct)
        acc = np.cumsum(occ)
        idx = int(np.searchsorted(acc, target))
        if idx >= len(vals):
            idx = len(vals) - 1
        return int(vals[idx])

    def threshold_word_freq(self, frac: float) -> int:
        """(reference merylOp-nextMer.C:117-119)"""
        return int(frac * self.n_total)

    # ---- set filters (reference merylOp.H:32-74 subset) ----

    def greater_than(self, x: int) -> "KmerCounts":
        m = self.counts > x
        return KmerCounts(self.k, self.kmers[m], self.counts[m])

    def less_than(self, x: int) -> "KmerCounts":
        m = self.counts < x
        return KmerCounts(self.k, self.kmers[m], self.counts[m])

    def at_least(self, x: int) -> "KmerCounts":
        m = self.counts >= x
        return KmerCounts(self.k, self.kmers[m], self.counts[m])

    def at_most(self, x: int) -> "KmerCounts":
        m = self.counts <= x
        return KmerCounts(self.k, self.kmers[m], self.counts[m])

    def equal_to(self, x: int) -> "KmerCounts":
        m = self.counts == x
        return KmerCounts(self.k, self.kmers[m], self.counts[m])

    def not_equal_to(self, x: int) -> "KmerCounts":
        m = self.counts != x
        return KmerCounts(self.k, self.kmers[m], self.counts[m])

    def decode(self, code: int) -> str:
        out = []
        for j in range(self.k - 1, -1, -1):
            out.append(_DECODE[(code >> (2 * j)) & 3])
        return "".join(out)

    def print_lines(self):
        """meryl `print` text form: 'KMER<TAB>count', ascending code order."""
        for code, cnt in zip(self.kmers.tolist(), self.counts.tolist()):
            yield f"{self.decode(code)}\t{cnt}"

    # ---- persistence: the real meryl v1 on-disk DB container, readable
    # by (and from) the reference meryl tools; legacy .npz DBs still load.

    def save(self, path: str) -> None:
        from .meryldb import write_meryl_db

        write_meryl_db(path, self.k, self.kmers, self.counts)

    @staticmethod
    def load(path: str) -> "KmerCounts":
        from .meryldb import is_meryl_db, read_meryl_db

        if is_meryl_db(path):
            k, kmers, counts = read_meryl_db(path)
            order = np.argsort(kmers)
            return KmerCounts(k, kmers[order], counts[order])
        f = np.load(os.path.join(path, "counts.npz"))
        return KmerCounts(int(f["k"]), f["kmers"], f["counts"])

    # ---- streaming set algebra with other databases ----

    def union_sum(self, other: "KmerCounts") -> "KmerCounts":
        ks = np.concatenate([self.kmers, other.kmers])
        cs = np.concatenate([self.counts, other.counts])
        order = np.argsort(ks, kind="stable")
        ks, cs = ks[order], cs[order]
        uk, start = np.unique(ks, return_index=True)
        sums = np.add.reduceat(cs, start)
        return KmerCounts(self.k, uk, sums)

    def intersect_min(self, other: "KmerCounts") -> "KmerCounts":
        common, ia, ib = np.intersect1d(
            self.kmers, other.kmers, assume_unique=True, return_indices=True
        )
        return KmerCounts(self.k, common, np.minimum(self.counts[ia], other.counts[ib]))

    def subtract(self, other: "KmerCounts") -> "KmerCounts":
        """counts minus other's counts, dropping non-positive."""
        idx = np.searchsorted(other.kmers, self.kmers)
        idxc = np.minimum(idx, max(len(other.kmers) - 1, 0))
        if len(other.kmers):
            hit = (idx < len(other.kmers)) & (other.kmers[idxc] == self.kmers)
            sub = np.where(hit, other.counts[idxc], 0)
        else:
            sub = np.zeros(len(self.kmers), dtype=np.int64)
        c = self.counts - sub
        m = c > 0
        return KmerCounts(self.k, self.kmers[m], c[m])

    def difference(self, other: "KmerCounts") -> "KmerCounts":
        """kmers present here but absent from other."""
        if len(other.kmers) == 0:
            return KmerCounts(self.k, self.kmers.copy(), self.counts.copy())
        idx = np.searchsorted(other.kmers, self.kmers)
        idxc = np.minimum(idx, len(other.kmers) - 1)
        hit = (idx < len(other.kmers)) & (other.kmers[idxc] == self.kmers)
        return KmerCounts(self.k, self.kmers[~hit], self.counts[~hit])

    # ---- value (math-constant) ops: reference merylOp-nextMer.C:514-557.
    # Counts are kmvalu = uint32 in the reference; a zero result drops the
    # k-mer from the output stream ("count=0 means don't output").

    def _keep_nonzero(self, c: np.ndarray) -> "KmerCounts":
        c = c.astype(np.int64)
        m = c > 0
        return KmerCounts(self.k, self.kmers[m], c[m])

    def increase(self, x: int) -> "KmerCounts":
        c = np.where(
            np.uint64(0xFFFFFFFFFFFFFFFF) - self.counts.astype(np.uint64)
            < np.uint64(x),
            np.uint64(0xFFFFFFFF),
            (self.counts.astype(np.uint64) + np.uint64(x))
            & np.uint64(0xFFFFFFFF))
        return self._keep_nonzero(c)

    def decrease(self, x: int) -> "KmerCounts":
        c = np.where(self.counts.astype(np.uint64) < np.uint64(x),
                     np.uint64(0),
                     self.counts.astype(np.uint64) - np.uint64(x))
        return self._keep_nonzero(c)

    def multiply(self, x: int) -> "KmerCounts":
        cnt = self.counts.astype(np.uint64)
        ovf = (np.uint64(0xFFFFFFFFFFFFFFFF) // np.maximum(cnt, 1)
               < np.uint64(x))
        c = np.where(ovf, np.uint64(0xFFFFFFFF),
                     (cnt * np.uint64(x)) & np.uint64(0xFFFFFFFF))
        return self._keep_nonzero(c)

    def divide(self, x: int) -> "KmerCounts":
        if x == 0:
            return KmerCounts(self.k, self.kmers[:0], self.counts[:0])
        return self._keep_nonzero(self.counts // x)

    def divide_round(self, x: int) -> "KmerCounts":
        """round(count/x) with C round() half-away-from-zero semantics;
        counts below x round up to 1 (reference merylOp-nextMer.C:541-550)."""
        if x == 0:
            return KmerCounts(self.k, self.kmers[:0], self.counts[:0])
        c = np.floor(self.counts / float(x) + 0.5).astype(np.int64)
        c = np.where(self.counts < x, 1, c)
        return self._keep_nonzero(c)

    def modulo(self, x: int) -> "KmerCounts":
        if x == 0:
            return KmerCounts(self.k, self.kmers[:0], self.counts[:0])
        return self._keep_nonzero(self.counts % x)


def nary_merge(op: str, dbs: list[KmerCounts]) -> KmerCounts:
    """N-ary streamed merge ops over sorted k-mer sets (reference
    merylOp-nextMer.C:559-612: union/union-min/union-max/union-sum,
    intersect/intersect-min/intersect-max/intersect-sum, subtract,
    difference, symmetric-difference).

    Semantics notes (all from the reference):
      * union        -> count = number of inputs containing the k-mer
      * intersect    -> count of the FIRST input (all inputs must contain)
      * subtract     -> k-mer kept iff present in input 0; count =
                        count0 - sum(others), dropped on underflow/zero
      * difference   -> present ONLY in input 0, original count
      * symmetric-difference -> present in exactly one input, its count
    """
    k = dbs[0].k
    allk = np.concatenate([d.kmers for d in dbs])
    allc = np.concatenate([d.counts for d in dbs])
    src = np.concatenate([np.full(len(d.kmers), i, np.int32)
                          for i, d in enumerate(dbs)])
    order = np.argsort(allk, kind="stable")
    allk, allc, src = allk[order], allc[order], src[order]
    uk, start = np.unique(allk, return_index=True)
    nmem = np.diff(np.append(start, len(allk)))
    if op == "union":
        c = nmem.astype(np.int64)
    elif op == "union_min":
        c = np.minimum.reduceat(allc, start) if len(allk) else allc[:0]
    elif op == "union_max":
        c = np.maximum.reduceat(allc, start) if len(allk) else allc[:0]
    elif op == "union_sum":
        c = np.add.reduceat(allc, start) if len(allk) else allc[:0]
    elif op.startswith("intersect"):
        m = nmem == len(dbs)
        if op == "intersect":
            # first input's count: stable sort keeps input order per k-mer
            c = allc[start]
        elif op == "intersect_min":
            c = np.minimum.reduceat(allc, start) if len(allk) else allc[:0]
        elif op == "intersect_max":
            c = np.maximum.reduceat(allc, start) if len(allk) else allc[:0]
        else:  # intersect_sum
            c = np.add.reduceat(allc, start) if len(allk) else allc[:0]
        return KmerCounts(k, uk[m], c[m].astype(np.int64))
    elif op == "subtract":
        in0 = src[start] == 0
        sums = np.add.reduceat(allc, start) if len(allk) else allc[:0]
        c0 = allc[start]
        c = np.where(c0 > sums - c0, c0 - (sums - c0), 0)
        m = in0 & (c > 0)
        return KmerCounts(k, uk[m], c[m].astype(np.int64))
    elif op == "difference":
        m = (nmem == 1) & (src[start] == 0)
        return KmerCounts(k, uk[m], allc[start][m].astype(np.int64))
    elif op == "symmetric_difference":
        m = nmem == 1
        return KmerCounts(k, uk[m], allc[start][m].astype(np.int64))
    else:
        raise ValueError(f"unknown n-ary op {op}")
    return KmerCounts(k, uk, c.astype(np.int64))


def compare_lines(a: KmerCounts, b: KmerCounts):
    """`meryl compare` stdout lines (reference merylOp-nextMer.C:617-634)."""
    allk = np.concatenate([a.kmers, b.kmers])
    allc = np.concatenate([a.counts, b.counts])
    src = np.concatenate([np.zeros(len(a.kmers), np.int32),
                          np.ones(len(b.kmers), np.int32)])
    order = np.argsort(allk, kind="stable")
    allk, allc, src = allk[order], allc[order], src[order]
    uk, start = np.unique(allk, return_index=True)
    nmem = np.diff(np.append(start, len(allk)))
    for i in range(len(uk)):
        s = start[i]
        if nmem[i] == 1:
            yield (f"kmer {a.decode(int(uk[i]))} only in input {src[s]}")
        elif nmem[i] == 2 and allc[s] != allc[s + 1]:
            yield (f"kmer {a.decode(int(uk[i]))} has value {allc[s]} in "
                   f"input 1 != value {allc[s + 1]} in input 2")


def _interpolate(h: np.ndarray, pp: int, bo: int, eo: int, x: float) -> float:
    """Lagrange interpolation through h[pp-bo..pp+eo] evaluated at x
    (reference kmers-histogram-ploidy.C:25-45)."""
    y = 0.0
    for ii in range(pp - bo, pp + eo + 1):
        t = float(h[ii])
        for jj in range(pp - bo, pp + eo + 1):
            if ii != jj:
                t *= (x - jj) / (ii - jj)
        y += t
    return y


def _find_interp_minmax(h, pp, rng, step, wantmin):
    """(reference kmers-histogram-ploidy.C:79-97)"""
    pmin, imin = pp + rng, float("inf")
    pmax, imax = pp - rng, float("-inf")
    ptst = pp - 1.5
    pend = pp + 1.5 + step * 1.1
    while ptst < pend:
        i = _interpolate(h, pp, rng + 1, rng + 1, ptst)
        if i < imin:
            pmin, imin = ptst, i
        if imax < i:
            pmax, imax = ptst, i
        ptst += step
    return pmin if wantmin else pmax


def _find_extrema(h, idx, rng):
    """idx'th alternating extremum (min/max/min/...) of the histogram
    (reference kmers-histogram-ploidy.C:117-156)."""
    for ii in range(3, 100):
        d0n = (h[ii + 1] - h[ii]) < 0
        d1n = (h[ii] - h[ii - 1]) < 0
        if d1n and not d0n:
            if idx == 0:
                return _find_interp_minmax(h, ii, rng, 0.025, True)
            idx -= 1
        elif (not d1n) and d0n:
            if idx == 0:
                return _find_interp_minmax(h, ii, rng, 0.025, False)
            idx -= 1
    return 0.0


def ploidy_report(kc: KmerCounts):
    """meryl `ploidy`: Weierstrass-smoothed histogram peak finding
    (reference merylOp-histogram.C:100-155,
    kmers-histogram-ploidy.C:219-339).  Returns (stderr_lines,
    stdout_line)."""
    import math

    t = 0.5
    iim = 9
    t4s = 1.0 / math.sqrt(4 * math.pi * t)
    t4n = -4 * t
    w = {ii: t4s * math.exp(ii * ii / t4n) for ii in range(-iim, iim + 1)}

    h = np.zeros(1026)
    s = np.zeros(1026)
    vals, occ = kc.histogram()
    for hv, ho in zip(vals.tolist(), occ.tolist()):
        if hv < 1024:
            h[hv] = ho
        else:
            break
    for hi in range(1024):
        for wi in range(-iim, iim + 1):
            whi = hi + wi
            if 1 <= whi < 1024:
                s[hi] += h[whi] * w[wi]

    peaks = np.zeros(9)
    ploidy = np.zeros(9)
    peaks[0] = _find_extrema(h, 0, 3)
    for ii in range(1, 9):
        ploidy[ii] = ii
        peaks[ii] = _find_extrema(s, 2 * ii - 1, 4)

    max_peak, mx = 1, peaks[1]
    my = _interpolate(h, int(round(mx)), 3, 3, mx)
    for ii in range(1, 9):
        x = peaks[ii]
        y = _interpolate(h, int(round(x)), 3, 3, x)
        if my < y:
            max_peak, mx, my = ii, x, y
    while max_peak > 1:
        ploidy /= 2.0
        max_peak -= 1

    err = [""]
    err.append(f"Noise/genomic trough: {peaks[0]:6.3f}")
    for i in range(1, 5):
        err.append(f"{ploidy[i]:4.2f}x coverage peak:   {peaks[i]:6.3f}")
    out = ("noise-trough\t%.3f\tploidy-peaks\t%.3f\t%.3f\t%.3f\t%.3f"
           % (peaks[0], peaks[1], peaks[2], peaks[3], peaks[4]))
    return err, out


def count_kmers(records, k: int, device=None,
                direction: str = "canonical",
                max_memory_bytes: int | None = None) -> KmerCounts:
    """Count k-mers over sequence records.

    direction: 'canonical' (min(fwd, revcomp), reference
    merylOp-countThreads.C:246), 'forward' (opCountForward) or 'reverse'
    (opCountReverse).

    The codes stream through blocks counted by KC on `device` (None: the
    card, which raises when there is none; "cpu": the same block path with
    KC's plain version).  An explicit max_memory_bytes asks for the host's
    memory-bounded counter instead, which counts in chunks and merges
    sorted runs (reference out-of-core batching, merylOp-count.C:577-644).
    Both give the same counted set."""
    if max_memory_bytes is not None:
        from .outofcore import count_kmers_chunked

        return count_kmers_chunked(records, k, direction=direction,
                                   max_memory_bytes=max_memory_bytes)
    from .device import count_kmers_device

    return count_kmers_device(records, k, direction=direction, device=device)


def lookup(counts: KmerCounts, seq: bytes) -> np.ndarray:
    """Per-k-mer counts of a query sequence (meryl-lookup equivalent,
    reference ext/meryl/src/meryl-lookup)."""
    codes = seq_to_kmers(seq, counts.k)
    idx = np.searchsorted(counts.kmers, codes)
    idxc = np.minimum(idx, max(len(counts.kmers) - 1, 0))
    if len(counts.kmers) == 0:
        return np.zeros(len(codes), dtype=np.int64)
    hit = (idx < len(counts.kmers)) & (counts.kmers[idxc] == codes)
    return np.where(hit, counts.counts[idxc], 0)
