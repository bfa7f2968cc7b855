"""Debug-dump instruments (reference mm_dbg_flag, src/mmpriv.h:11-15).

The reference's correctness instruments are stderr trace lines gated by
mm_dbg_flag: QR per-read headers (map.c:1015-1016), RS/SD seed dumps and
CN chain dumps (map.c:867-921 and the MCAS trial variants), PO MCAS trial
traces (map.c:462-473,634-645,688-707), and per-DP-call sequence/CIGAR
dumps (align.c:315-338), in the JAX package's formats byte for byte.

The reference and the JAX package write them one read at a time (the
dumps force one thread, main.c:211-215).  The port maps a batch's reads
together on the generator path (map/batch.map_batch_generator), so every
writer here writes to `sink`, which the batch driver points at the buffer
of the read (and of its trial) whose generator is running; the driver then
writes each read's buffers to stderr in read order, which gives the
per-read trace.  With `sink` None they go to stderr.
"""
from __future__ import annotations

import sys

import numpy as np

DBG_PRINT_QNAME = 0x2
DBG_PRINT_SEED = 0x4
DBG_PRINT_ALN_SEQ = 0x8
DBG_POLISH = 0x10

flag = 0
# where the writers write (a text buffer of the running read), else stderr
sink = None


def _out():
    return sys.stderr if sink is None else sink


def write(text: str) -> None:
    _out().write(text)


def ref_radix_argsort(keys: np.ndarray) -> np.ndarray:
    """Permutation of `keys` exactly as the reference's in-place radix sort
    produces it (ksort.h KRADIX_SORT_INIT: MSD 8-bit American-flag cycles,
    insertion sort under 64 elements; NOT stable for equal keys).  The
    unstable equal-key order is observable in the SD/CN debug dumps, so the
    dump modes order anchors through this replica (map/seeds._anchor_order);
    the other paths keep the stable numpy sort (outputs are equal either
    way on the goldens: tests/test_torch_dbg.py)."""
    n = len(keys)
    idx = np.arange(n, dtype=np.int64)
    key = np.asarray(keys, np.uint64)

    def insertsort(lo: int, hi: int) -> None:
        for i in range(lo + 1, hi):
            t = idx[i]
            kt = key[t]
            if kt < key[idx[i - 1]]:
                j = i
                while j > lo and kt < key[idx[j - 1]]:
                    idx[j] = idx[j - 1]
                    j -= 1
                idx[j] = t

    def rs(beg: int, end: int, s: int) -> None:
        bb = np.zeros(256, np.int64)  # bucket fill pointers (absolute)
        ee = np.zeros(256, np.int64)  # bucket end pointers (absolute)
        dig = ((key[idx[beg:end]] >> np.uint64(s))
               & np.uint64(0xFF)).astype(np.int64)
        cnt = np.bincount(dig, minlength=256)
        ends = beg + np.cumsum(cnt)
        ee[:] = ends
        bb[0] = beg
        bb[1:] = ends[:-1]
        starts = bb.copy()
        k = 0
        sh = np.uint64(s)
        while k != 256:
            if bb[k] != ee[k]:
                li = int((key[idx[bb[k]]] >> sh) & np.uint64(0xFF))
                if li != k:
                    tmp = idx[bb[k]]
                    while True:
                        swap = tmp
                        tmp = idx[bb[li]]
                        idx[bb[li]] = swap
                        bb[li] += 1
                        li = int((key[tmp] >> sh) & np.uint64(0xFF))
                        if li == k:
                            break
                    idx[bb[k]] = tmp
                    bb[k] += 1
                else:
                    bb[k] += 1
            else:
                k += 1
        if s:
            s2 = s - 8 if s > 8 else 0
            for k in range(256):
                lo, hi = int(starts[k]), int(ee[k])
                if hi - lo > 64:
                    rs(lo, hi, s2)
                elif hi - lo > 1:
                    insertsort(lo, hi)

    if n <= 64:
        insertsort(0, n)
    else:
        rs(0, n, 56)
    return idx


def _anchor_cols(mi, ax, ay):
    i32 = lambda v: v.astype(np.uint32).astype(np.int32)  # noqa: E731
    rid = ((ax << np.uint64(1)) >> np.uint64(33)).astype(np.int64)
    strand = (ax >> np.uint64(63)).astype(np.int64)
    rpos = i32(ax)
    qpos = i32(ay)
    span = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    return rid, strand, rpos, qpos, span


def dump_seeds(mi, ax, ay, rep_len: int) -> None:
    """RS + SD lines over the collected anchors (reference map.c:867-872)."""
    w = _out().write
    w(f"RS\t{int(rep_len)}\n")
    if len(ax) == 0:
        return
    rid, strand, rpos, qpos, span = _anchor_cols(mi, ax, ay)
    gd = np.zeros(len(ax), np.int64)
    gd[1:] = (qpos[1:].astype(np.int64) - qpos[:-1]) - \
        (rpos[1:].astype(np.int64) - rpos[:-1])
    seqs = mi.seqs
    for i in range(len(ax)):
        w(f"SD\t{seqs[rid[i]].name}\t{rpos[i]}\t{'+-'[strand[i]]}\t{qpos[i]}"
          f"\t{span[i]}\t{int(gd[i])}\n")


def dump_chains(mi, regs, ax, ay) -> None:
    """CN lines over the post-chain anchors per region (map.c:919-921)."""
    w = _out().write
    if len(ax) == 0:
        return
    rid, strand, rpos, qpos, span = _anchor_cols(mi, ax, ay)
    seqs = mi.seqs
    for j, r in enumerate(regs):
        as_ = r.as_
        for i in range(as_, as_ + r.cnt):
            gd = 0 if i == as_ else (
                (int(qpos[i]) - int(qpos[i - 1]))
                - (int(rpos[i]) - int(rpos[i - 1])))
            w(f"CN\t{j}\t{seqs[rid[i]].name}\t{rpos[i]}\t{'+-'[strand[i]]}"
              f"\t{qpos[i]}\t{span[i]}\t{gd}\n")


def dump_qr(qname, tid: int, qlen: int) -> None:
    _out().write(f"QR\t{qname}\t{tid}\t{qlen}\n")


_ACGTN = "ACGTN"


def dump_aln_pre(opt, w, flag_, tseq, qseq) -> None:
    """Pre-DP sequence dump (reference align.c:315-322; note the reference
    prints opt->zdrop regardless of the zdrop actually passed)."""
    out = _out()
    out.write(f"===> q=({opt.q},{opt.q2}), e=({opt.e},{opt.e2}), "
              f"bw={w}, flag={flag_}, zdrop={opt.zdrop} <===\n")
    out.write("".join(_ACGTN[c] for c in tseq))
    out.write("\n")
    out.write("".join(_ACGTN[c] for c in qseq))
    out.write("\n")


def dump_aln_post(score: int, cigar) -> None:
    """Post-DP score/CIGAR dump (reference align.c:332-338)."""
    out = _out()
    out.write(f"score={int(score)}, cigar=")
    for c in np.asarray(cigar, np.uint32):
        out.write(f"{int(c) >> 4}{'MIDN'[int(c) & 0xF]}")
    out.write("\n")


def dump_po_found(qname, qlen, r, mi, suffix_id, sub_begin, sub_len) -> None:
    """PO accept line (map.c:464-465 right / 636-637 left: sub_len is
    negative for left trials and shifts the printed q coords)."""
    if sub_len >= 0:
        qs, qe = sub_begin + r.qs, sub_begin + r.qe
    else:
        qs, qe = sub_begin + sub_len + r.qs, sub_begin + sub_len + r.qe
    _out().write(
        f"PO\t{qname} {qlen} {qs} {qe} {'+-'[r.rev]} {mi.seqs[r.rid].name} "
        f"{mi.seqs[r.rid].length} {r.rs} {r.re} {r.mapq} {suffix_id} "
        f"{sub_begin} {sub_len} [FOUND] \n")


def dump_po_trial_none(qname, suffix_id, sub_begin, sub_len, max_mapq,
                       n_regs0) -> None:
    _out().write(
        f"PO\tqname:{qname}, suffid:{suffix_id}, begin:{sub_begin}, "
        f"len:{sub_len}, max_mapq:{max_mapq}, n_regs0:{n_regs0} "
        f"[NONE FOUND] \n")


def dump_po_pos_none(qname, sub_begin, max_mapq_current) -> None:
    _out().write(
        f"PO\tqname:{qname}, begin:{sub_begin}, "
        f"max_mapq_currentPos:{max_mapq_current} [NONE FOUND] \n")


def dump_po_summary(qname, seq_mapped) -> None:
    n = int(np.count_nonzero(seq_mapped))
    _out().write(
        f"PO\tqname:{qname}, count of mapped query bases = {n} among "
        f"{len(seq_mapped)}\n")
