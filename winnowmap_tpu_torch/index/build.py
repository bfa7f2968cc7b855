"""Minimizer index: flat sorted arrays (reference mm_idx_gen + mm_idx_post,
src/index.c:200-360).

  keys  : unique minimizer keys, sorted ascending (uint64)
  start : offset of each key's occurrence run in ``pos``
  pos   : occurrence records y = rid<<32|lastpos<<1|strand, sorted ascending
          within each run
  codes : the reference as 0..4 codes, all sequences concatenated

Sketching uses the native weighted-minimizer sketch (native/src/wm_sketch.cpp).
The index is built on the host; MapEngine uploads ``codes`` to the device
once per batch (extend/kernels.PoolContext).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np

from .. import native
from ..io.seqcode import encode


@dataclass
class SeqMeta:
    name: str
    offset: int
    length: int


@dataclass
class MinimizerIndex:
    w: int
    k: int
    flag: int = 0
    seqs: list[SeqMeta] = field(default_factory=list)
    keys: np.ndarray = None  # uint64, unique minimizer keys (hash part, x>>8)
    start: np.ndarray = None  # int64 run starts into pos (len = len(keys)+1)
    pos: np.ndarray = None  # uint64 occurrence records (y layout)
    codes: np.ndarray = None  # uint8 packed reference
    # exact down-weighted k-mer set (sorted canonical codes)
    wset: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint64))
    # --bloom-filter strict-parity mode: (table u8, table_bits, salt0, salt1)
    bloom: tuple | None = None
    index_part: int = 0
    # splice-junction intervals (--junc-bed); empty until reading a BED
    # file is ported, and map_batch refuses a spliced run that has them
    intervals: dict = field(default_factory=dict)
    # device copies of `codes`, keyed by device (extend/kernels.PoolContext)
    device_codes: dict = field(default_factory=dict, repr=False,
                               compare=False)

    @property
    def n_seq(self) -> int:
        return len(self.seqs)

    def getseq(self, rid: int, st: int, en: int) -> np.ndarray:
        """Reference segment as 0..4 codes (reference mm_idx_getseq,
        src/index.c:161-171)."""
        s = self.seqs[rid]
        en = min(en, s.length)
        return self.codes[s.offset + st:s.offset + en]

    def cal_max_occ(self, f: float) -> int:
        """Occurrence-count quantile (reference mm_idx_cal_max_occ,
        src/index.c:173-194): the ((1-f)*n)-th smallest count + 1."""
        if f <= 0.0:
            return 2**31 - 1
        cnt = np.diff(self.start).astype(np.uint32)
        if len(cnt) == 0:
            return 2**31 - 1
        kk = int((1.0 - f) * len(cnt))
        kk = min(max(kk, 0), len(cnt) - 1)
        return int(np.partition(cnt, kk)[kk]) + 1

    def stat_line(self) -> str:
        n = len(self.keys)
        if n == 0:
            return "empty index"
        cnt = np.diff(self.start)
        n1 = int((cnt == 1).sum())
        tot_len = sum(s.length for s in self.seqs)
        return (
            f"distinct minimizers: {n} ({100.0 * n1 / n:.2f}% are singletons); "
            f"average occurrences: {cnt.mean():.3f}; "
            f"average spacing: {tot_len / cnt.sum():.3f}"
        )


def _read_kmers(path: str, k: int) -> np.ndarray:
    codes = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            kmer = parts[0]
            if len(kmer) != k:
                raise ValueError(
                    f"input list of k-mers (len {len(kmer)}) and parameter k={k} "
                    "are inconsistent")
            codes.append(native.encode_kmer(kmer.encode()))
    return np.array(codes, dtype=np.uint64)


def load_weight_bloom(path: str | None, k: int) -> tuple | None:
    """Load a meryl-style k-mer list into a reference-exact bloom filter
    (strict-parity mode; reference src/index.c:410-437).  Returns (table u8
    array, table_bits, salt0, salt1), or None for no list."""
    if not path:
        return None
    arr = _read_kmers(path, k)
    L = native.lib()
    bits = ctypes.c_uint64()
    s0 = ctypes.c_uint32()
    s1 = ctypes.c_uint32()
    L.wm_bloom_params(max(len(arr), 1), ctypes.byref(bits), ctypes.byref(s0),
                      ctypes.byref(s1))
    table = np.zeros(int(bits.value) // 8, np.uint8)
    if len(arr):
        L.wm_bloom_build(np.ascontiguousarray(arr), len(arr),
                         bits.value, s0.value, s1.value, table)
    return (table, int(bits.value), int(s0.value), int(s1.value))


def load_weight_set(path: str | None, k: int) -> np.ndarray:
    """Read a meryl-style 'KMER<TAB>count' list into a sorted canonical-code
    array (the exact set; reference src/index.c:388-437 uses a bloom)."""
    if not path:
        return np.zeros(0, dtype=np.uint64)
    return np.sort(_read_kmers(path, k))


def build_index(records, w: int, k: int, flag: int = 0,
                weight_set: np.ndarray | None = None, is_hpc: bool = False,
                weight_bloom: tuple | None = None) -> MinimizerIndex:
    """Build the flat sorted index from SeqRecords with the native sketch
    (reference mm_idx_gen + mm_idx_post, src/index.c:289-360,200-257)."""
    mi = MinimizerIndex(w=w, k=k, flag=flag)
    if weight_set is not None:
        mi.wset = weight_set
    mi.bloom = weight_bloom
    total = 0
    for rec in records:
        mi.seqs.append(SeqMeta(rec.name, total, len(rec.seq)))
        total += len(rec.seq)
    codes = np.empty(total, dtype=np.uint8)
    xs, ys = [], []
    for rid, rec in enumerate(records):
        s = mi.seqs[rid]
        codes[s.offset:s.offset + s.length] = encode(rec.seq)
        if s.length > 0:
            x, y = native.sketch(rec.seq, w, k, rid, is_hpc, mi.wset,
                                 bloom=mi.bloom)
            xs.append(x)
            ys.append(y)
    mi.codes = codes
    x = np.concatenate(xs) if xs else np.zeros(0, np.uint64)
    y = np.concatenate(ys) if ys else np.zeros(0, np.uint64)
    keys = x >> np.uint64(8)
    # group by key, occurrences sorted by y (stable two-key sort)
    order = np.lexsort((y, keys))
    keys = keys[order]
    y = y[order]
    uniq, start_idx = np.unique(keys, return_index=True)
    mi.keys = uniq
    mi.start = np.append(start_idx, len(keys)).astype(np.int64)
    mi.pos = y
    return mi
