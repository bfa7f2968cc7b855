"""Minimizer index: flat sorted arrays (reference mm_idx_gen + mm_idx_post,
src/index.c:200-360).

  keys  : unique minimizer keys, sorted ascending (uint64)
  start : offset of each key's occurrence run in ``pos``
  pos   : occurrence records y = rid<<32|lastpos<<1|strand, sorted ascending
          within each run
  codes : the reference as 0..4 codes, all sequences concatenated

A genome of build_index's sketch_min_bp (DEVICE_SKETCH_MIN_BP by default)
or more bases is sketched with the per-base work on the device
(sketch/device.sketch_records: S1 on a card, one launch for the genome's
records, the winnowing automaton on the host), as the JAX package's index
build sketches on its device; a smaller one with the native
weighted-minimizer sketch (native/src/wm_sketch.cpp).  Both give the same
minimizers.  The index arrays stay on the host; MapEngine uploads
``codes`` to the device once per batch (extend/kernels.PoolContext).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np

from .. import native
from ..device import resolve_device
from ..io.seqcode import encode
from ..sketch.device import sketch_records, weights_on

# genomes of at least this many bases sketch through the device transform
# (the JAX package's gate, winnowmap_tpu/index/build.py:257-267)
DEVICE_SKETCH_MIN_BP = 1_000_000
# codes an S1 launch takes at most (its outputs take 17 bytes a code on the
# card and as many in pinned host memory): a larger genome's records go in
# several launches
SKETCH_MAX_CODES = 1 << 28


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
    # per-rid splice-junction intervals (reference mm_idx_intv_t, loaded
    # from BED by read_bed): dict rid -> (st, en, strand) int64 arrays
    intervals: dict = field(default_factory=dict)
    # device copies of `codes`, keyed by device (extend/kernels.PoolContext)
    device_codes: dict = field(default_factory=dict, repr=False,
                               compare=False)

    @property
    def n_seq(self) -> int:
        return len(self.seqs)

    def name_to_rid(self) -> dict[str, int]:
        return {s.name: i for i, s in enumerate(self.seqs)}

    def get_batch(self, query_keys: np.ndarray):
        """Vectorised lookup (reference mm_idx_get, src/index.c:88-105);
        returns (found mask, run start, run count)."""
        n = len(self.keys)
        idx = np.searchsorted(self.keys, query_keys)
        if n == 0:
            z = np.zeros(len(query_keys), np.int64)
            return np.zeros(len(query_keys), bool), z, z
        idx_c = np.minimum(idx, n - 1)
        found = (idx < n) & (self.keys[idx_c] == query_keys)
        rs = np.where(found, self.start[idx_c], 0)
        rc = np.where(found, self.start[idx_c + 1] - self.start[idx_c], 0)
        return found, rs, rc

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
    return weight_bloom(_read_kmers(path, k))


def weight_bloom(kmers: np.ndarray) -> tuple:
    """The reference-exact bloom filter of canonical k-mer codes (u64):
    (table u8 array, table_bits, salt0, salt1)."""
    L = native.lib()
    bits = ctypes.c_uint64()
    s0 = ctypes.c_uint32()
    s1 = ctypes.c_uint32()
    L.wm_bloom_params(max(len(kmers), 1), ctypes.byref(bits),
                      ctypes.byref(s0), ctypes.byref(s1))
    table = np.zeros(int(bits.value) // 8, np.uint8)
    if len(kmers):
        L.wm_bloom_build(np.ascontiguousarray(kmers, np.uint64), len(kmers),
                         bits.value, s0.value, s1.value, table)
    return (table, int(bits.value), int(s0.value), int(s1.value))


def load_weight_set(path: str | None, k: int) -> np.ndarray:
    """Read a meryl-style 'KMER<TAB>count' list into a sorted canonical-code
    array (the exact set; reference src/index.c:388-437 uses a bloom)."""
    if not path:
        return np.zeros(0, dtype=np.uint64)
    return np.sort(_read_kmers(path, k))


def _launch_groups(seqs) -> list[list[int]]:
    """The rids of consecutive records, grouped for S1 launches of at most
    SKETCH_MAX_CODES codes (a longer record alone)."""
    groups, size = [[]], 0
    for rid, s in enumerate(seqs):
        if groups[-1] and size + s.length > SKETCH_MAX_CODES:
            groups.append([])
            size = 0
        groups[-1].append(rid)
        size += s.length
    return groups


def genome_codes(records, seqs: list) -> np.ndarray:
    """The records' codes concatenated; appends each record's SeqMeta to
    seqs."""
    total = 0
    for rec in records:
        seqs.append(SeqMeta(rec.name, total, len(rec.seq)))
        total += len(rec.seq)
    codes = np.empty(total, dtype=np.uint8)
    for s, rec in zip(seqs, records):
        codes[s.offset:s.offset + s.length] = encode(rec.seq)
    return codes


def sketch_genome(records, codes, seqs, w: int, k: int, is_hpc: bool,
                  wset: np.ndarray, bloom: tuple | None, device=None,
                  sketch_min_bp: int | None = DEVICE_SKETCH_MIN_BP):
    """Each record's minimizers (x, y), in sketch order: a genome of
    sketch_min_bp or more bases on `device` (None: the card, which raises
    when there is none), one S1 launch a SKETCH_MAX_CODES of records; a
    smaller one, or any with sketch_min_bp None, with the native sketch,
    and the device is not asked for.  codes/seqs: the genome's codes and
    each record's SeqMeta; an empty record gives no entry on the native
    route."""
    xs, ys = [], []
    if sketch_min_bp is not None and len(codes) >= sketch_min_bp:
        wt = weights_on(wset, bloom, resolve_device(device))
        for group in _launch_groups(seqs):
            res = sketch_records([codes[seqs[r].offset:seqs[r].offset
                                        + seqs[r].length] for r in group],
                                 w, k, group, is_hpc, wt)
            xs += [x for x, _ in res]
            ys += [y for _, y in res]
    else:
        for rid, rec in enumerate(records):
            if len(rec.seq) > 0:
                x, y = native.sketch(rec.seq, w, k, rid, is_hpc, wset,
                                     bloom)
                xs.append(x)
                ys.append(y)
    return xs, ys


def build_index(records, w: int, k: int, flag: int = 0,
                weight_set: np.ndarray | None = None, is_hpc: bool = False,
                weight_bloom: tuple | None = None, device=None,
                sketch_min_bp: int | None = DEVICE_SKETCH_MIN_BP
                ) -> MinimizerIndex:
    """Build the flat sorted index from SeqRecords (reference mm_idx_gen +
    mm_idx_post, src/index.c:289-360,200-257).  A genome of sketch_min_bp
    or more bases sketches on `device` (None: the card, which raises when
    there is none) in one S1 launch (one a SKETCH_MAX_CODES of records); a
    smaller one, or any with sketch_min_bp None, with the native sketch,
    and the device is not asked for (sketch_genome)."""
    mi = MinimizerIndex(w=w, k=k, flag=flag)
    if weight_set is not None:
        mi.wset = weight_set
    mi.bloom = weight_bloom
    codes = genome_codes(records, mi.seqs)
    xs, ys = sketch_genome(records, codes, mi.seqs, w, k, is_hpc, mi.wset,
                           mi.bloom, device, sketch_min_bp)
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


def read_bed(mi: MinimizerIndex, path: str, read_junc: bool = True) -> None:
    """Load splice junctions from BED6/BED12 (reference mm_idx_read_bed,
    src/index.c:690-777): BED12 blocks become the introns between blocks;
    simple BED lines are taken as intervals directly."""
    name2rid = mi.name_to_rid()
    per = {}
    with open(path) as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 3 or cols[0] not in name2rid:
                continue
            rid = name2rid[cols[0]]
            st, en = int(cols[1]), int(cols[2])
            if st < 0 or st >= en:
                continue
            strand = 0
            if len(cols) >= 6:
                strand = 1 if cols[5] == "+" else -1 if cols[5] == "-" else 0
            lst = per.setdefault(rid, [])
            if read_junc and len(cols) >= 12 and cols[9].isdigit():
                n_blk = int(cols[9])
                sizes = [int(x) for x in cols[10].rstrip(",").split(",")]
                starts = [int(x) for x in cols[11].rstrip(",").split(",")]
                en_b = st + starts[0] + sizes[0]
                for i in range(1, n_blk):
                    s_, e_ = en_b, st + starts[i]
                    en_b = st + starts[i] + sizes[i]
                    if e_ > s_:
                        lst.append((s_, e_, strand))
            else:
                lst.append((st, en, strand))
    for rid, lst in per.items():
        lst.sort(key=lambda t: t[0])
        a = np.array(lst, np.int64).reshape(-1, 3)
        mi.intervals[rid] = (a[:, 0], a[:, 1], a[:, 2])


def bed_junc(mi: MinimizerIndex, rid: int, st: int, en: int) -> np.ndarray:
    """Per-base junction flags over [st, en) (reference mm_idx_bed_junc,
    src/index.c:780-803): donor/acceptor bits by annotated strand, for the
    intervals that lie wholly inside the window."""
    out = np.zeros(en - st, np.uint8)
    iv = mi.intervals.get(rid)
    if iv is None:
        return out
    ist, ien, istr = iv
    m = (ist >= st) & (ien <= en) & (istr != 0)
    for s_, e_, sd in zip(ist[m].tolist(), ien[m].tolist(),
                          istr[m].tolist()):
        if sd > 0:
            out[s_ - st] |= 1
            out[e_ - 1 - st] |= 2
        else:
            out[s_ - st] |= 8
            out[e_ - 1 - st] |= 4
    return out
