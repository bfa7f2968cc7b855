"""Per-read mapping orchestration of the generator path (reference
mm_map_frag, src/map.c:279-981).

Two-stage SV-aware (MCAS) mapping: stage 1 maps sampled substrings of the
read and pools the anchors of confident sub-alignments; stage 2 re-chains
and re-aligns the whole read from the pooled anchors.  The vanilla
single-pass pipeline runs when SV-aware mode is off, the read is short, or
no confident substring mapping was found.  Every function here is a
generator of extension-DP jobs (map/align.py); map/batch.run_ext_tasks
runs them on the device.  Chaining calls `chain_dp`, a function with
native.chain_dp's signature: map/batch.py passes chain/device.chain_dp_auto
on the batch's device, which chains the large anchor sets there.
Fragments of several segments (paired ends, --frag) map through
map_frag_gen.  The debug dumps (utils/dbg) write where dbg.sink points:
map/batch.py points it at the running read's buffer.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..options import (
    MM_MAX_SEG,
    MM_F_ALL_CHAINS,
    MM_F_CIGAR,
    MM_F_HARD_MLEVEL,
    MM_F_NO_LJOIN,
    MM_F_SPLICE,
    MM_F_SR,
    stage1_options,
    stage2_options,
)
from ..utils import dbg
from . import hit as hitmod
from . import pe as pemod
from .align import align_skeleton_gen
from .esterr import est_err
from .hit import set_mapq, set_parent, set_sam_pri, select_sub
from .seeds import collect_minimizers, collect_seed_hits

U64 = np.uint64
U32MASK = 0xFFFFFFFF


def _x31_hash(s: str) -> int:
    h = 0
    for ch in s.encode():
        h = ((h << 5) - h + ch) & U32MASK
    return h


def _wang_hash(key: int) -> int:
    key = (key + (~(key << 15) & U32MASK)) & U32MASK
    key ^= key >> 10
    key = (key + (key << 3)) & U32MASK
    key ^= key >> 6
    key = (key + (~(key << 11) & U32MASK)) & U32MASK
    key ^= key >> 16
    return key


def _frag_hash(qname: str | None, qlen_sum: int, seed: int) -> int:
    h = _x31_hash(qname) if qname else 0
    h ^= (_wang_hash(qlen_sum) + _wang_hash(seed)) & U32MASK
    h &= U32MASK
    return _wang_hash(h)


@dataclass
class MapResult:
    regs: list
    rep_len: int
    frag_gap: int
    # False when the reference leaves rep_len uninitialized on this path
    # (MCAS success with full read coverage, reference map.c:281 vs 917:
    # outer rep_len is never written before use -- a reference UB we resolve
    # to 0).  Tests treat rl/MAPQ as unspecified for such reads.
    rep_len_defined: bool = True


def _chain_gaps(opt, is_sr, qlen_sum):
    """(reference map.c:373-388)"""
    if is_sr:
        max_chain_gap_qry = max(qlen_sum, opt.max_gap)
    else:
        max_chain_gap_qry = opt.max_gap
    if opt.max_gap_ref > 0:
        max_chain_gap_ref = opt.max_gap_ref
    elif opt.max_frag_len > 0:
        max_chain_gap_ref = max(opt.max_frag_len - qlen_sum, opt.max_gap)
    else:
        max_chain_gap_ref = opt.max_gap
    min_chain_gap_ref = min(opt.min_gap_ref, max_chain_gap_ref)
    return max_chain_gap_qry, max_chain_gap_ref, min_chain_gap_ref


def _chain(opt, ax, ay, qlen, is_cdna: int, chain_dp, n_segs=1):
    """Chain anchors with chain_dp (reference mm_chain_dp); qlen is the
    segments' summed length."""
    max_gap_qry, max_gap_ref, min_gap_ref = _chain_gaps(
        opt, bool(opt.flag & MM_F_SR), qlen)
    u, ax, ay = chain_dp(
        ax, ay, max_dist_x=max_gap_ref, min_dist_x=min_gap_ref,
        max_dist_y=max_gap_qry, bw=opt.bw, max_skip=opt.max_chain_skip,
        max_iter=opt.max_chain_iter, min_cnt=opt.min_cnt,
        min_sc=opt.min_chain_score, gap_scale=opt.chain_gap_scale,
        is_cdna=is_cdna, n_segs=n_segs)
    return u, ax, ay, max_gap_ref


def chain_post(opt, mi, qlen, regs, ax, ay, n_segs=1, max_gap_ref=0,
               qlens=None):
    """(reference chain_post, map.c:256-265; several segments select their
    secondaries with mm_select_sub_multi, which reads max_gap_ref and the
    segments' lengths)"""
    if not (opt.flag & MM_F_ALL_CHAINS):
        set_parent(opt.mask_level, opt.mask_len, regs, opt.a * 2 + opt.b,
                   opt.flag & MM_F_HARD_MLEVEL, opt.alt_drop)
        if n_segs <= 1:
            regs = select_sub(opt.pri_ratio, mi.k * 2, opt.best_n, regs)
        else:
            regs = pemod.select_sub_multi(opt.pri_ratio, 0.2, 0.7,
                                          max_gap_ref, mi.k * 2, opt.best_n,
                                          n_segs, qlens, regs)
        if not (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_NO_LJOIN)):
            regs = hitmod.join_long(opt, qlen, regs, ax, ay)
    return regs


def align_regs_gen(opt, mi, qlen, regs, ax, ay, qseq0):
    """(reference align_regs, map.c:267-277)"""
    if not (opt.flag & MM_F_CIGAR):
        return regs
    regs, ax, ay = yield from align_skeleton_gen(opt, mi, qlen, regs, ax, ay,
                                                 qseq0)
    if not (opt.flag & MM_F_ALL_CHAINS):
        set_parent(opt.mask_level, opt.mask_len, regs, opt.a * 2 + opt.b,
                   opt.flag & MM_F_HARD_MLEVEL, opt.alt_drop)
        regs = select_sub(opt.pri_ratio, mi.k * 2, opt.best_n, regs)
        set_sam_pri(regs)
    return regs


def _pipeline_once_gen(mi, opt, qlen, seq, qname, hash_, run_est_err,
                       qseq0, chain_dp):
    """One seed -> chain -> post -> align -> mapq pass, the core of both the
    vanilla path and each MCAS substring trial (reference map.c:343-470)."""
    is_sr = bool(opt.flag & MM_F_SR)
    mvx, mvy = collect_minimizers(opt, mi, [qlen], [seq])
    sh = collect_seed_hits(opt, opt.mid_occ, mi, qname, mvx, mvy, qlen)
    if dbg.flag & dbg.DBG_PRINT_SEED:
        dbg.dump_seeds(mi, sh.ax, sh.ay, sh.rep_len)
    # (the rechain with a higher occurrence cutoff, reference map.c:391-413,
    # fires only when opt.max_occ > opt.mid_occ, which no preset sets)
    u, ax, ay, max_gap_ref = _chain(opt, sh.ax, sh.ay, qlen,
                                    int(bool(opt.flag & MM_F_SPLICE)),
                                    chain_dp)
    regs = hitmod.gen_regs(hash_, qlen, u, ax, ay)
    if dbg.flag & dbg.DBG_PRINT_SEED:
        dbg.dump_chains(mi, regs, ax, ay)
    regs = chain_post(opt, mi, qlen, regs, ax, ay)
    # the reference runs mm_est_err only inside MCAS stage-1 trials
    # (map.c:426); the final/vanilla pass has it disabled (map.c:928-929)
    if not is_sr and run_est_err:
        est_err(mi, qlen, regs, ax, ay, sh.mini_pos)
    regs = yield from align_regs_gen(opt, mi, qlen, regs, ax, ay, qseq0)
    set_mapq(regs, opt.min_chain_score, opt.a, sh.rep_len, is_sr)
    return regs, ax, ay, sh.rep_len, max_gap_ref


def read_prologue(opt, qname, qlen: int) -> None:
    """The trace lines a read starts with (reference mm_map_frag as the
    JAX package's map_one writes them): QR, and under --dbg-polish, for a
    read that takes no MCAS trials, the PO summary and its fallback."""
    if dbg.flag & dbg.DBG_PRINT_QNAME:
        dbg.dump_qr(qname, 0, qlen)  # tid 0: the dump modes are one thread
    sv_read = opt.sv_aware and qlen >= opt.sv_aware_min_read_length
    if (dbg.flag & dbg.DBG_POLISH) and not sv_read:
        # the PO summary and fallback print for every read; only the trial
        # section is length-gated (map.c:313,700-707,735-737,849-853)
        dbg.dump_po_summary(qname, np.zeros(qlen, bool))
        if opt.sv_aware:
            dbg.write(f"PO\tqname:{qname}, n_a (before filtering and "
                      f"checking for duplicates) :0\n")
            dbg.write(f"PO\tfalling back to default mapping algorithm for "
                      f"read: {qname}\n")


def _map_vanilla_gen(mi, opt, seq, qname, qseq0, chain_dp):
    """Single-pass path (reference map.c:848-954; also the fallback when
    MCAS found no anchors)."""
    qlen = len(seq)
    hash_ = _frag_hash(qname, qlen, opt.seed)
    regs, ax, ay, rep_len, frag_gap = yield from _pipeline_once_gen(
        mi, opt, qlen, seq, qname, hash_, False, qseq0, chain_dp)
    return MapResult(regs, rep_len, frag_gap)


def _stage2_chain_gen(mi, opt3, qlen, qname, ax_in, ay_in, rep_len,
                      rep_len_defined, qseq0, chain_dp):
    """Stage-2 chain/align from a pooled anchor set (reference
    map.c:848-954 with pre-collected anchors)."""
    is_sr = bool(opt3.flag & MM_F_SR)
    hash_ = _frag_hash(qname, qlen, opt3.seed)
    if dbg.flag & dbg.DBG_PRINT_SEED:
        dbg.dump_seeds(mi, ax_in, ay_in, rep_len)
    u, ax, ay, max_gap_ref = _chain(opt3, ax_in, ay_in, qlen, 0, chain_dp)
    regs = hitmod.gen_regs(hash_, qlen, u, ax, ay)
    if dbg.flag & dbg.DBG_PRINT_SEED:
        dbg.dump_chains(mi, regs, ax, ay)
    regs = chain_post(opt3, mi, qlen, regs, ax, ay)
    # stage 2 skips mm_est_err (reference map.c:928-929 commented out)
    regs = yield from align_regs_gen(opt3, mi, qlen, regs, ax, ay, qseq0)
    set_mapq(regs, opt3.min_chain_score, opt3.a, rep_len, is_sr)
    return MapResult(regs, rep_len, max_gap_ref, rep_len_defined)


class McasState:
    """Shared per-read MCAS stage-1 state (reference map.c:305-312); trial
    generators for different start positions write disjoint slots, as the
    reference's OpenMP-parallel substring loop does (map.c:317-334)."""

    def __init__(self, opt, seq, qseq0, chain_dp):
        self.qlen = len(seq)
        self.chain_dp = chain_dp
        self.opt2 = stage1_options(opt)
        self.n_starts = 1 + math.ceil(self.qlen
                                      / self.opt2.suffix_sample_offset)
        self.collect_ax = [None] * self.n_starts
        self.collect_ay = [None] * self.n_starts
        self.seq_mapped = np.zeros(self.qlen, dtype=bool)
        self.qseq0 = qseq0

    def trial_gens(self, mi, seq, qname):
        return [self._trial_gen(mi, seq, qname, sid)
                for sid in range(self.n_starts)]

    def _trial_gen(self, mi, seq, qname, suffix_id):
        """All substring trials for one start position (reference
        map.c:334-688: geometric length ladder, right then left)."""
        opt2, qlen = self.opt2, self.qlen
        sub_begin = suffix_id * opt2.suffix_sample_offset
        if sub_begin >= qlen:
            sub_begin = qlen - 1
        found = False
        max_mapq_current = 0  # reference map.c:339 (for the PO trace)
        sub_len = opt2.min_prefix_length
        while sub_len <= opt2.max_prefix_length:
            for left in (False, True):
                if left:
                    fits = sub_begin - sub_len + 1 >= 0
                else:
                    fits = sub_begin + sub_len <= qlen
                if fits:
                    found, n_regs0, mq = yield from _mcas_try_gen(
                        mi, opt2, seq, qname, sub_begin, sub_len, left, qlen,
                        self, suffix_id)
                    max_mapq_current = max(max_mapq_current, mq)
                    if found or not n_regs0:
                        sub_len = opt2.max_prefix_length + 1  # the ladder ends
                        break
            else:
                sub_len = int(sub_len * opt2.prefix_increment_factor)
        if (dbg.flag & dbg.DBG_POLISH) and not found:
            dbg.dump_po_pos_none(qname, sub_begin, max_mapq_current)


def mcas_stage2_gen(mi, opt, seq, qname, st: McasState):
    """Anchor pooling + stage-2 re-chain/re-align (reference
    map.c:713-954)."""
    if dbg.flag & dbg.DBG_POLISH:
        dbg.dump_po_summary(qname, st.seq_mapped)  # reference map.c:700-707
    qlen = len(seq)
    opt3 = stage2_options(opt)

    # pool + dedupe anchors (reference map.c:732-781)
    pooled = [(x, y) for x, y in zip(st.collect_ax, st.collect_ay)
              if x is not None and len(x) > 0]
    if (dbg.flag & dbg.DBG_POLISH) and opt.sv_aware:
        dbg.write(f"PO\tqname:{qname}, n_a (before filtering and checking "
                  f"for duplicates) :{sum(len(p[0]) for p in pooled)}\n")
    rep_len = 0
    rep_len_defined = False
    ax = ay = None
    if pooled:
        ax = np.concatenate([p[0] for p in pooled])
        ay = np.concatenate([p[1] for p in pooled])
        order = np.lexsort((ay, ax))
        ax, ay = ax[order], ay[order]
        keep = np.ones(len(ax), dtype=bool)
        if len(ax) > 1:
            keep[1:] = (ax[1:] != ax[:-1]) | (ay[1:] != ay[:-1])
        ax, ay = ax[keep], ay[keep]
        if dbg.flag & dbg.DBG_POLISH:
            dbg.write(f"PO\tqname:{qname}, n_a (after filtering and "
                      f"checking for duplicates) :{len(ax)}, min_cnt:"
                      f"{opt3.min_cnt}\n")
        # already sorted by (x, y); the reference's stable re-sort by x
        # keeps this order
        if len(ax) < opt3.min_cnt:
            ax = ay = None

    # collect additional anchors from unmapped intervals (reference
    # map.c:788-845)
    if ax is not None and not st.seq_mapped.all():
        masked = bytearray(seq)
        for i in np.nonzero(st.seq_mapped)[0]:
            masked[i] = ord("N")
        mvx, mvy = collect_minimizers(opt3, mi, [qlen], [bytes(masked)])
        sh = collect_seed_hits(opt3, opt3.mid_occ, mi, qname, mvx, mvy, qlen)
        rep_len = sh.rep_len
        rep_len_defined = True
        ax = np.concatenate([ax, sh.ax])
        ay = np.concatenate([ay, sh.ay])
        order = np.argsort(ax, kind="stable")
        ax, ay = ax[order], ay[order]

    if ax is None:
        # MCAS unusable: the vanilla path with the original options (its
        # jobs' scoring equals stage 2's, so they share calls with them)
        if (dbg.flag & dbg.DBG_POLISH) and opt.sv_aware:
            dbg.write(f"PO\tfalling back to default mapping algorithm for "
                      f"read: {qname}\n")
        result = yield from _map_vanilla_gen(mi, opt, seq, qname, st.qseq0,
                                             st.chain_dp)
        return result
    result = yield from _stage2_chain_gen(mi, opt3, qlen, qname, ax, ay,
                                          rep_len, rep_len_defined, st.qseq0,
                                          st.chain_dp)
    return result


def sub_qseq0(qseq0, qlen, start, sub_len):
    """Strand views for the substring [start, start+sub_len) of a read whose
    full-strand views are qseq0: fwd slice of fwd, rev slice of rev (the
    revcomp of a substring is a substring of the revcomp)."""
    fwd = qseq0[0][start:start + sub_len]
    rev = qseq0[1][qlen - start - sub_len:qlen - start]
    return [fwd, rev]


def _mcas_try_gen(mi, opt2, seq, qname, sub_begin, sub_len, left, qlen,
                  st: McasState, suffix_id):
    """Try mapping one substring; on success save its shifted anchors
    (reference map.c:346-515 right, 518-687 left).  Returns (found, number
    of regions, their largest MAPQ)."""
    start = sub_begin - sub_len + 1 if left else sub_begin
    sub = seq[start:start + sub_len]
    hash_ = _frag_hash(qname, sub_len, opt2.seed)
    regs0, ax, ay, _, _ = yield from _pipeline_once_gen(
        mi, opt2, sub_len, sub, qname, hash_, True,
        sub_qseq0(st.qseq0, qlen, start, sub_len), st.chain_dp)
    max_mapq = 0  # reference map.c:447-453 (PO trace bookkeeping)
    for r in regs0:
        max_mapq = max(max_mapq, r.mapq)
        if (r.mapq >= opt2.min_mapq and r.blen >= opt2.min_qcov * sub_len
                and r.cnt > 0):
            if dbg.flag & dbg.DBG_POLISH:
                dbg.dump_po_found(qname, qlen, r, mi, suffix_id, sub_begin,
                                  -sub_len if left else sub_len)
            sel_ax = ax[r.as_:r.as_ + r.cnt].copy()
            sel_ay = ay[r.as_:r.as_ + r.cnt].copy()
            # shift anchor query coordinates into whole-read space
            # (reference map.c:486-496 / 658-668)
            rev_mask = (sel_ax >> U64(63)).astype(bool)
            if left:
                shift_fwd = sub_begin - sub_len + 1
                shift_rev = (qlen - 1) - sub_begin
            else:
                shift_fwd = sub_begin
                shift_rev = qlen - sub_begin - sub_len
            sel_ay = sel_ay + np.where(rev_mask, np.uint64(shift_rev),
                                       np.uint64(shift_fwd))
            st.collect_ax[suffix_id] = sel_ax
            st.collect_ay[suffix_id] = sel_ay
            st.seq_mapped[start:start + sub_len] = True
            return True, len(regs0), max_mapq
    if dbg.flag & dbg.DBG_POLISH:
        dbg.dump_po_trial_none(qname, suffix_id, sub_begin,
                               -sub_len if left else sub_len, max_mapq,
                               len(regs0))
    return False, len(regs0), max_mapq


def map_frag_gen(mi, opt, seqs, qname, qseq0s, chain_dp):
    """Multi-segment fragment mapping (reference mm_map_frag for
    n_segs > 1, as the JAX package's map_frag_gen): the vanilla seeding and
    chaining over the segments' concatenated coordinates (map.c:849-954),
    the per-segment chain split (mm_seg_gen, hit.c:373-435), per-segment
    alignment, each segment's jobs on its own views qseq0s[s] of the read
    pool (map.c:602-613), and mm_pair (pe.c:76) when two CIGAR'd segments
    remain.  MCAS never applies: the reference samples substrings of
    seqs[0] only, for one-segment reads.  Returns one MapResult a
    segment."""
    n_segs = len(seqs)
    qlens = [len(s) for s in seqs]
    qlen_sum = sum(qlens)
    empty = [MapResult([], 0, 0) for _ in range(n_segs)]
    if qlen_sum == 0 or n_segs <= 0 or n_segs > MM_MAX_SEG:
        return empty
    if opt.max_qlen > 0 and qlen_sum > opt.max_qlen:
        return empty
    is_sr = bool(opt.flag & MM_F_SR)
    hash_ = _frag_hash(qname, qlen_sum, opt.seed)
    mvx, mvy = collect_minimizers(opt, mi, qlens, seqs)
    sh = collect_seed_hits(opt, opt.mid_occ, mi, qname, mvx, mvy, qlen_sum)
    # several segments chain on the host: C1 takes one segment
    # (chain/device.chain_dp_auto)
    u, ax, ay, max_gap_ref = _chain(opt, sh.ax, sh.ay, qlen_sum,
                                    int(bool(opt.flag & MM_F_SPLICE)),
                                    chain_dp, n_segs)
    regs0 = hitmod.gen_regs(hash_, qlen_sum, u, ax, ay)
    regs0 = chain_post(opt, mi, qlen_sum, regs0, ax, ay, n_segs, max_gap_ref,
                       qlens)
    segs = hitmod.seg_gen(hash_, qlens, regs0, ax, ay)
    all_regs = []
    for s in range(n_segs):
        regs_s, ax_s, ay_s = segs[s]
        set_parent(opt.mask_level, opt.mask_len, regs_s, opt.a * 2 + opt.b,
                   opt.flag & MM_F_HARD_MLEVEL, opt.alt_drop)
        regs_s = yield from align_regs_gen(opt, mi, qlens[s], regs_s, ax_s,
                                           ay_s, qseq0s[s])
        set_mapq(regs_s, opt.min_chain_score, opt.a, sh.rep_len, is_sr)
        all_regs.append(regs_s)
    if n_segs == 2 and opt.pe_ori >= 0 and (opt.flag & MM_F_CIGAR):
        pemod.pair(max_gap_ref, opt.pe_bonus, opt.a * 2 + opt.b, opt.a,
                   qlens, all_regs)
    return [MapResult(regs, sh.rep_len, max_gap_ref) for regs in all_regs]
