"""Memory-bounded k-mer counting (reference merylOp-count.C:577-644).

The reference counts into bit-packed prefix buckets and, when the memory
budget fills, sorts and dumps each bucket to disk as an intermediate batch,
merging all batches at finish.  The TPU-shaped equivalent keeps the
sort-based formulation: k-mer codes accumulate into a bounded buffer; each
full buffer becomes a sorted run-length (kmers, counts) run; runs beyond
the resident budget spill to temp memmaps; a final chunked two-pointer
merge produces the counted set without ever materializing more than the
budget of transient data.

Long sequences are additionally scanned in bounded windows (with k-1
overlap) so the per-sequence transient (codes + fwd/rev rolls, ~24 B/base
in the naive formulation) never exceeds the window size — a 3 Gbp
chromosome streams through a few MB of scratch.

A copy of winnowmap_tpu/kcount/outofcore.py: the host counter that the
device path's results are held to, and the merge of its sorted runs.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

# window of bases scanned per vectorized roll (transient ~24 B/base)
SEQ_WINDOW = 8 << 20


def _rle(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    codes.sort(kind="stable")
    uk, counts = np.unique(codes, return_counts=True)
    return uk, counts.astype(np.int64)


class _Run:
    """One sorted unique (kmers, counts) run, resident or spilled."""

    def __init__(self, kmers, counts, spill_dir=None):
        self.n = len(kmers)
        if spill_dir is not None and self.n:
            self._kpath = tempfile.mktemp(dir=spill_dir, suffix=".k")
            self._cpath = tempfile.mktemp(dir=spill_dir, suffix=".c")
            km = np.memmap(self._kpath, np.uint64, "w+", shape=(self.n,))
            cm = np.memmap(self._cpath, np.int64, "w+", shape=(self.n,))
            km[:] = kmers
            cm[:] = counts
            km.flush()
            cm.flush()
            self.kmers = np.memmap(self._kpath, np.uint64, "r",
                                   shape=(self.n,))
            self.counts = np.memmap(self._cpath, np.int64, "r",
                                    shape=(self.n,))
        else:
            self._kpath = self._cpath = None
            self.kmers = kmers
            self.counts = counts

    def cleanup(self):
        for p in (self._kpath, self._cpath):
            if p and os.path.exists(p):
                os.unlink(p)


def _merge_two(a: _Run, b: _Run, spill_dir, chunk: int) -> _Run:
    """Chunked two-pointer merge of two sorted unique runs, summing counts
    of shared k-mers.  Both runs are cut at a shared inclusive upper bound
    per step, so a k-mer never straddles a chunk boundary."""
    out_k, out_c = [], []
    parts_k, parts_c = [], []
    i = j = 0
    while i < a.n or j < b.n:
        ka = a.kmers[i:i + chunk]
        kb = b.kmers[j:j + chunk]
        if len(ka) == 0:
            hi = kb[-1]
        elif len(kb) == 0:
            hi = ka[-1]
        else:
            hi = min(ka[-1], kb[-1])
        ea = i + int(np.searchsorted(ka, hi, side="right"))
        eb = j + int(np.searchsorted(kb, hi, side="right"))
        mk = np.concatenate([a.kmers[i:ea], b.kmers[j:eb]])
        mc = np.concatenate([a.counts[i:ea], b.counts[j:eb]])
        order = np.argsort(mk, kind="stable")
        mk, mc = mk[order], mc[order]
        uk, start = np.unique(mk, return_index=True)
        sums = np.add.reduceat(mc, start) if len(mk) else mc[:0]
        parts_k.append(uk)
        parts_c.append(sums.astype(np.int64))
        i, j = ea, eb
        if sum(len(p) for p in parts_k) >= chunk * 4:
            out_k.append(np.concatenate(parts_k))
            out_c.append(np.concatenate(parts_c))
            parts_k, parts_c = [], []
    if parts_k:
        out_k.append(np.concatenate(parts_k))
        out_c.append(np.concatenate(parts_c))
    kmers = (np.concatenate(out_k) if out_k else np.zeros(0, np.uint64))
    counts = (np.concatenate(out_c) if out_c else np.zeros(0, np.int64))
    r = _Run(kmers, counts, spill_dir)
    a.cleanup()
    b.cleanup()
    return r


def iter_kmer_windows(seq: bytes, k: int, direction: str):
    """Yield k-mer code arrays of one sequence in bounded windows."""
    from . import seq_to_kmers

    n = len(seq)
    if n < k:
        return
    step = SEQ_WINDOW
    for lo in range(0, n, step):
        hi = min(n, lo + step + k - 1)
        yield seq_to_kmers(seq[lo:hi], k, direction=direction)
        if hi == n:
            break


def count_kmers_chunked(records, k: int, direction: str = "canonical",
                        max_memory_bytes: int | None = None):
    """Count k-mers with a bounded transient working set.

    max_memory_bytes=None keeps everything resident (windowed scanning
    aside); a budget spills sorted runs to a temp dir and merges them
    chunk-wise (reference out-of-core batching, merylOp-count.C:577-644)."""
    from . import KmerCounts

    budget = max_memory_bytes or None
    # buffer of raw codes before a run is formed (8 B/code)
    buf_codes = (budget // 4 if budget else 1 << 62) // 8
    buf_codes = max(buf_codes, 1 << 20)
    spill_dir = None
    tmp_ctx = None
    if budget:
        tmp_ctx = tempfile.TemporaryDirectory(prefix="wm_kcount_")
        spill_dir = tmp_ctx.name

    runs: list[_Run] = []
    pend: list[np.ndarray] = []
    pend_n = 0

    def flush_pend():
        nonlocal pend, pend_n
        if not pend_n:
            return
        uk, counts = _rle(np.concatenate(pend))
        runs.append(_Run(uk, counts, spill_dir))
        pend, pend_n = [], 0

    for rec in records:
        for codes in iter_kmer_windows(rec.seq, k, direction):
            pend.append(codes)
            pend_n += len(codes)
            if pend_n >= buf_codes:
                flush_pend()
    flush_pend()

    if not runs:
        return KmerCounts(k, np.zeros(0, np.uint64), np.zeros(0, np.int64))
    chunk = max(1 << 20, (budget // 64 if budget else 1 << 62))
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(_merge_two(runs[i], runs[i + 1], spill_dir, chunk))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    final = runs[0]
    kc = KmerCounts(k, final.kmers, final.counts)
    if spill_dir is not None:
        # memmap-backed result: the temp dir must outlive the KmerCounts
        kc._spill_ctx = tmp_ctx
    return kc
