"""Base-level alignment skeleton (reference src/align.c).

Per chain: left extension, anchor-to-anchor gap filling with two-pass
z-drop, right extension; CIGAR normalisation and score/blen/mlen
recomputation (native.update_extra); z-drop inspection with inversion
rescue.  The chain-level functions are generators: each extension-DP job is
yielded as a tuple (opt, qseq, tseq, mat, w, end_bonus, zdrop, flag, junc)
whose sequences are JobSeq views into the read pool or the reference codes,
and the result comes back from the device (map/batch.run_ext_tasks ->
extend/kernels.DevCallPooled).  align_pair computes on the host only the
jobs whose result the oracle's own refusal guards decide (refused()).
"""
from __future__ import annotations

import copy
import math

import numpy as np

from .. import native
from ..extend.kernels import (EZ_APPROX_MAX, EZ_EXTZ_ONLY, EZ_REV_CIGAR,
                              EZ_RIGHT, EZ_SPLICE_FLANK, EZ_SPLICE_FOR,
                              EZ_SPLICE_REV)
from ..index.build import bed_junc
from ..options import (
    MM_F_EQX,
    MM_F_FOR_ONLY,
    MM_F_NO_END_FLT,
    MM_F_REV_ONLY,
    MM_F_SPLICE,
    MM_F_SPLICE_FLANK,
    MM_F_SPLICE_FOR,
    MM_F_SPLICE_REV,
    MM_F_SR,
    MM_SEED_IGNORE,
    MM_SEED_LONG_JOIN,
    MM_SEED_SELF,
    MM_SEED_TANDEM,
)
from .hit import (
    MM_PARENT_TMP_PRI,
    MM_PARENT_UNSET,
    Extra,
    Reg,
    _i32,
    filter_regs,
    hit_sort,
    split_reg,
    squeeze_a,
)

U64 = np.uint64

_MAT_CACHE: dict = {}


def gen_simple_mat(a: int, b: int, sc_ambi: int) -> np.ndarray:
    """5x5 match/mismatch matrix, memoized per (a, b, sc_ambi); read-only."""
    key = (a, b, sc_ambi)
    cached = _MAT_CACHE.get(key)
    if cached is not None:
        return cached
    a = abs(a)
    b = -abs(b)
    sc_ambi = -abs(sc_ambi)
    mat = np.zeros(25, dtype=np.int8)
    for i in range(4):
        for j in range(4):
            mat[i * 5 + j] = a if i == j else b
        mat[i * 5 + 4] = sc_ambi
    for j in range(5):
        mat[20 + j] = sc_ambi
    mat.setflags(write=False)
    _MAT_CACHE[key] = mat
    return mat


class JobSeq:
    """A zero-copy sequence operand for an extension job: a contiguous view
    into the read pool (a read's fwd/rev strand) or the reference codes,
    and whether the DP reads it reversed.  The scheduler resolves it to a
    pool offset (extend/kernels.PoolContext.resolve), so per-job sequence
    bytes never cross to the device; materialize() gives the bytes for the
    host-decided jobs."""

    __slots__ = ("view", "rev")

    def __init__(self, view, rev=False):
        self.view = view
        self.rev = rev

    def __len__(self):
        return len(self.view)

    def materialize(self):
        v = self.view[::-1] if self.rev else self.view
        return np.ascontiguousarray(v)


def _seq_of(x):
    return x.materialize() if isinstance(x, JobSeq) else x


def refused(opt, qlen: int, tlen: int) -> bool:
    """True for a job whose result the oracle's own refusal guards decide
    (the engine's device_eligible, native/src/wm_engine.cpp): an empty
    side, --cap-sw-mem's dummy drop, and a spliced profile that wm_exts
    refuses (q2 <= q + e, or a mismatch or N score beyond 2(q + e))."""
    if qlen == 0 or tlen == 0:
        return True
    if opt.max_sw_mat > 0 and qlen * tlen > opt.max_sw_mat:
        return True
    if opt.flag & MM_F_SPLICE:
        if opt.q2 <= opt.q + opt.e:
            return True
        if max(abs(opt.b), abs(opt.sc_ambi)) > 2 * (opt.q + opt.e):
            return True
    return False


def align_pair(opt, qseq, tseq, mat, w, end_bonus, zdrop, flag, junc=None):
    """The result of a refused() job (reference mm_align_pair,
    align.c:313-339): --cap-sw-mem's dummy drop, else the oracle's empty
    result.  Never a place a job can fall back to: it raises for any other
    job."""
    qseq = _seq_of(qseq)
    tseq = _seq_of(tseq)
    qlen, tlen = len(qseq), len(tseq)
    if not refused(opt, qlen, tlen):
        raise ValueError("align_pair only computes refused jobs; this one "
                         "belongs on the device")
    if opt.max_sw_mat > 0 and tlen * qlen > opt.max_sw_mat:
        r = native.ExtResult.__new__(native.ExtResult)
        r.max = 0
        r.zdropped = True
        r.max_q = r.max_t = r.mqe_t = r.mte_q = -1
        r.mqe = r.mte = r.score = -0x40000000
        r.reach_end = False
        r.cigar = np.zeros(0, np.uint32)
        return r
    if opt.flag & MM_F_SPLICE:
        return native.exts(qseq, tseq, mat, opt.q, opt.e, opt.q2, opt.noncan,
                           zdrop, opt.junc_bonus, flag, junc=junc)
    if opt.q == opt.q2 and opt.e == opt.e2:
        return native.extz(qseq, tseq, mat, opt.q, opt.e, w, zdrop,
                           end_bonus, flag)
    return native.extd(qseq, tseq, mat, opt.q, opt.e, opt.q2, opt.e2, w,
                       zdrop, end_bonus, flag)


def _append_cigar(r: Reg, cigar: np.ndarray) -> None:
    """(reference mm_append_cigar, align.c:288-311)"""
    if len(cigar) == 0:
        return
    if r.p is None:
        r.p = Extra()
    old = r.p.cigar
    if len(old) > 0 and (old[-1] & 0xF) == (cigar[0] & 0xF):
        merged = np.concatenate([old[:-1], cigar])
        merged[len(old) - 1] += old[-1] >> 4 << 4
        r.p.cigar = merged
    else:
        r.p.cigar = np.concatenate([old, cigar])


def test_zdrop(opt, qseq, tseq, cigar, mat) -> int:
    """Z-drop inspection + inversion probe (reference mm_test_zdrop,
    align.c:47-89).  Returns 0 (ok), 1 (z-dropped), 2 (inversion)."""
    return native.test_zdrop(
        qseq, tseq, cigar, mat, q=opt.q, e=opt.e, zdrop=opt.zdrop,
        zdrop_inv=opt.zdrop_inv, max_gap=opt.max_gap,
        min_inv_score=opt.min_chain_score * opt.a, min_dp_max=opt.min_dp_max,
        try_inv=not (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_FOR_ONLY
                                 | MM_F_REV_ONLY)),
    )


def update_extra(r: Reg, qseq, tseq, mat, q, e, is_eqx) -> None:
    """Recompute dp_max/blen/mlen from the final CIGAR
    (reference mm_update_extra, align.c:240-286)."""
    p = r.p
    if p is None:
        return
    new_cigar, f = native.update_extra(
        qseq, tseq, p.cigar, mat, q, e, is_eqx,
        qs=r.qs, qe=r.qe, rs=r.rs, re=r.re, rev=r.rev,
    )
    r.qs, r.qe, r.rs, r.re = f["qs"], f["qe"], f["rs"], f["re"]
    r.blen, r.mlen = f["blen"], f["mlen"]
    p.n_ambi += f["n_ambi"]
    p.dp_max = f["dp_max"]
    p.cigar = new_cigar


def _collect_long_gaps(as1, cnt1, ax, ay, min_gap):
    axi = ax[as1:as1 + cnt1].astype(np.uint32).astype(np.int32).astype(np.int64)
    ayi = ay[as1:as1 + cnt1].astype(np.uint32).astype(np.int32).astype(np.int64)
    gap = np.diff(ayi) - np.diff(axi)
    K = (np.nonzero((gap < -min_gap) | (gap > min_gap))[0] + 1).tolist()
    return K if len(K) > 1 else []


def filter_bad_seeds(as1, cnt1, ax, ay, min_gap, diff_thres, max_ext_len, max_ext_cnt):
    """Mark seeds inside indel-dense windows (reference mm_filter_bad_seeds,
    align.c:386-421)."""
    K = _collect_long_gaps(as1, cnt1, ax, ay, min_gap)
    if not K:
        return
    n = len(K)
    max_ = 0
    max_st = max_en = -1
    k = 0
    while True:
        if k == n or k >= max_en:
            if max_en > 0:
                for i in range(K[max_st], K[max_en]):
                    ay[as1 + i] = U64(int(ay[as1 + i]) | MM_SEED_IGNORE)
            max_ = 0
            max_st = max_en = -1
            if k == n:
                break
        i = K[k]
        gap = (_i32(ay[as1 + i]) - _i32(ay[as1 + i - 1])) - (
            _i32(ax[as1 + i]) - _i32(ax[as1 + i - 1])
        )
        n_ins = gap if gap > 0 else 0
        n_del = -gap if gap <= 0 else 0
        qs = _i32(ay[as1 + i - 1])
        rs = _i32(ax[as1 + i - 1])
        max_diff = 0
        max_diff_l = -1
        l = k + 1
        while l < n and l <= k + max_ext_cnt:
            j = K[l]
            if _i32(ay[as1 + j]) - qs > max_ext_len or _i32(ax[as1 + j]) - rs > max_ext_len:
                break
            gap = (_i32(ay[as1 + j]) - _i32(ay[as1 + j - 1])) - (
                _i32(ax[as1 + j]) - _i32(ax[as1 + j - 1])
            )
            if gap > 0:
                n_ins += gap
            else:
                n_del += -gap
            diff = n_ins + n_del - abs(n_ins - n_del)
            if max_diff < diff:
                max_diff = diff
                max_diff_l = l
            l += 1
        if max_diff > diff_thres and max_diff > max_:
            max_ = max_diff
            max_st = k
            max_en = max_diff_l
        k += 1


def filter_bad_seeds_alt(as1, cnt1, ax, ay, min_gap, max_ext):
    """(reference mm_filter_bad_seeds_alt, align.c:423-457)"""
    K = _collect_long_gaps(as1, cnt1, ax, ay, min_gap)
    if not K:
        return
    n = len(K)
    k = 0
    while k < n:
        i = K[k]
        gap1 = (_i32(ay[as1 + i]) - _i32(ay[as1 + i - 1])) - (
            _i32(ax[as1 + i]) - _i32(ax[as1 + i - 1])
        )
        re1 = _i32(ax[as1 + i])
        qe1 = _i32(ay[as1 + i])
        gap1 = abs(gap1)
        l = k + 1
        while l < n:
            j = K[l]
            if _i32(ay[as1 + j]) - qe1 > max_ext or _i32(ax[as1 + j]) - re1 > max_ext:
                break
            gap2 = (_i32(ay[as1 + j]) - _i32(ay[as1 + j - 1])) - (
                _i32(ax[as1 + j]) - _i32(ax[as1 + j - 1])
            )
            q_span_pre = int(ay[as1 + j - 1] >> U64(32) & U64(0xFF))
            rs2 = _i32(ax[as1 + j - 1]) + q_span_pre
            qs2 = _i32(ay[as1 + j - 1]) + q_span_pre
            m = min(rs2 - re1, qs2 - qe1)
            gap2 = abs(gap2)
            if m > gap1 + gap2:
                break
            re1 = _i32(ax[as1 + j])
            qe1 = _i32(ay[as1 + j])
            gap1 = gap2
            l += 1
        if l > k + 1:
            end = K[l - 1]
            for j in range(K[k], end):
                ay[as1 + j] = U64(int(ay[as1 + j]) | MM_SEED_IGNORE)
            ay[as1 + end] = U64(int(ay[as1 + end]) | MM_SEED_LONG_JOIN)
        k = l


def fix_bad_ends(r: Reg, ax, ay, bw, min_match):
    """Trim unreliable chain ends (reference mm_fix_bad_ends, align.c:459-493)."""
    as_, cnt = r.as_, r.cnt
    if r.cnt < 3:
        return as_, cnt
    a0, a1 = r.as_, r.as_ + r.cnt
    ay_full = ay[a0:a1]
    spans = ((ay_full >> U64(32)) & U64(0xFF)).astype(np.int64).tolist()
    axi = ax[a0:a1].astype(np.uint32).astype(np.int32).astype(np.int64).tolist()
    ayi = ay_full.astype(np.uint32).astype(np.int32).astype(np.int64).tolist()
    lj = (ay_full.astype(np.int64) & np.int64(MM_SEED_LONG_JOIN)) != 0
    lj = lj.tolist()
    m = l = spans[0]
    for i in range(1, r.cnt - 1):
        q_span = spans[i]
        if lj[i]:
            break
        lr = axi[i] - axi[i - 1]
        lq = ayi[i] - ayi[i - 1]
        mn, mx = (lr, lq) if lr < lq else (lq, lr)
        if mx - mn > l >> 1:
            as_ = a0 + i
        l += mn
        m += mn if mn < q_span else q_span
        if l >= bw << 1 or (m >= min_match and m >= bw) or m >= r.mlen >> 1:
            break
    cnt = a1 - as_
    m = l = spans[r.cnt - 1]
    for i in range(r.cnt - 2, as_ - a0, -1):
        q_span = spans[i + 1]
        if lj[i + 1]:
            break
        lr = axi[i + 1] - axi[i]
        lq = ayi[i + 1] - ayi[i]
        mn, mx = (lr, lq) if lr < lq else (lq, lr)
        if mx - mn > l >> 1:
            cnt = a0 + i + 1 - as_
        l += mn
        m += mn if mn < q_span else q_span
        if l >= bw << 1 or (m >= min_match and m >= bw) or m >= r.mlen >> 1:
            break
    return as_, cnt


def max_stretch(r: Reg, ax, ay):
    """Longest exact-colinear run (reference mm_max_stretch, align.c:495-521);
    used in short-read mode."""
    as_, cnt = r.as_, r.cnt
    if r.cnt < 2:
        return as_, cnt
    max_score, max_i, max_len = -1, -1, 0
    score = int(ay[r.as_] >> U64(32) & U64(0xFF))
    length = 1
    i = r.as_ + 1
    for i in range(r.as_ + 1, r.as_ + r.cnt):
        q_span = int(ay[i] >> U64(32) & U64(0xFF))
        lr = _i32(ax[i]) - _i32(ax[i - 1])
        lq = _i32(ay[i]) - _i32(ay[i - 1])
        if lq == lr:
            score += min(lq, q_span)
            length += 1
        else:
            if score > max_score:
                max_score, max_len, max_i = score, length, i - length
            score = q_span
            length = 1
    i = r.as_ + r.cnt
    if score > max_score:
        max_score, max_len, max_i = score, length, i - length
    return max_i, max_len


def seed_ext_score(opt, mi, mat, qlen, qseq0, axv, ayv):
    """Local-SW score of a single seed's neighbourhood (reference
    mm_seed_ext_score, align.c:523-543)."""
    q_span = int(ayv >> U64(32) & U64(0xFF))
    rid = int(axv << U64(1) >> U64(33))
    re = _i32(axv) + 1
    rs = re - q_span
    qe = _i32(ayv) + 1
    qs = qe - q_span
    ext = opt.anchor_ext_len
    rs = max(rs - ext, 0)
    qs = max(qs - ext, 0)
    re = min(re + ext, mi.seqs[rid].length)
    qe = min(qe + ext, qlen)
    tseq = mi.getseq(rid, rs, re)
    qseq = qseq0[int(axv >> U64(63))][qs:qe]
    sc, _, _ = native.sw_score(qseq, tseq, mat, opt.q, opt.e)
    return sc


def fix_bad_ends_splice(opt, mi, r: Reg, mat, qlen, qseq0, ax, ay):
    """Trim weak boundary exon seeds (reference mm_fix_bad_ends_splice,
    align.c:545-563)."""
    as1, cnt1 = r.as_, r.cnt
    if r.cnt < 3:
        return as1, cnt1
    log_gap = math.log(_i32(ax[r.as_ + 1]) - _i32(ax[r.as_]))
    if int(ay[r.as_] >> U64(32) & U64(0xFF)) < log_gap + opt.anchor_ext_shift:
        score = seed_ext_score(opt, mi, mat, qlen, qseq0, ax[r.as_], ay[r.as_])
        if score / mat[0] < log_gap + opt.anchor_ext_shift:
            as1 += 1
            cnt1 -= 1
    log_gap = math.log(
        _i32(ax[r.as_ + r.cnt - 1]) - _i32(ax[r.as_ + r.cnt - 2]))
    if int(ay[r.as_ + r.cnt - 1] >> U64(32) & U64(0xFF)) < (
            log_gap + opt.anchor_ext_shift):
        score = seed_ext_score(opt, mi, mat, qlen, qseq0,
                               ax[r.as_ + r.cnt - 1], ay[r.as_ + r.cnt - 1])
        if score / mat[0] < log_gap + opt.anchor_ext_shift:
            cnt1 -= 1
    return as1, cnt1


def adjust_minier(mi, qseq0, axv, ayv):
    """Anchor end -> base coordinate (reference mm_adjust_minier,
    align.c:350-365)."""
    if mi.flag & 1:  # HPC
        rev = int(axv >> U64(63))
        qseq = qseq0[rev]
        q = _i32(ayv)
        c = qseq[q]
        i = q - 1
        while i > 0 and qseq[i] == c:
            i -= 1
        q = i + 1
        rid = int(axv << U64(1) >> U64(33))
        x = _i32(axv)
        off0 = mi.seqs[rid].offset
        off = off0 + x
        c = mi.codes[off]
        i = off - 1
        while i >= off0 and mi.codes[i] == c:
            i -= 1
        r = x + 1 - int(off - i)
        return r, q
    r = _i32(axv) - (mi.k >> 1)
    q = _i32(ayv) - (mi.k >> 1)
    return r, q


def align1_gen(opt, mi, qlen, qseq0, r: Reg, n_a, ax, ay, splice_flag):
    """Align one chain (reference mm_align1, align.c:565-795), as a
    generator that yields extension-DP jobs (a tuple, or a list of tuples
    for the chain's gap fills) and receives native.ExtResult-like results
    (a list for a list), so a scheduler can run many chains' DP on the
    device at once.  Returns (r2, dropped): r2 is a split-off region or
    None."""
    is_sr = bool(opt.flag & MM_F_SR)
    is_splice = bool(opt.flag & MM_F_SPLICE)
    rid = int(ax[r.as_] << U64(1) >> U64(33))
    rev = int(ax[r.as_] >> U64(63))
    if r.cnt == 0:
        return None, False
    mat = gen_simple_mat(opt.a, opt.b, opt.sc_ambi)
    bw = int(opt.bw * 1.5 + 1.0)
    r2 = None

    if is_sr:
        as1, cnt1 = max_stretch(r, ax, ay)
        rs = _i32(ax[as1]) + 1 - int(ay[as1] >> U64(32) & U64(0xFF))
        qs = _i32(ay[as1]) + 1 - int(ay[as1] >> U64(32) & U64(0xFF))
        re = _i32(ax[as1 + cnt1 - 1]) + 1
        qe = _i32(ay[as1 + cnt1 - 1]) + 1
    else:
        if not (opt.flag & MM_F_NO_END_FLT):
            if is_splice:
                as1, cnt1 = fix_bad_ends_splice(opt, mi, r, mat, qlen,
                                                qseq0, ax, ay)
            else:
                as1, cnt1 = fix_bad_ends(r, ax, ay, opt.bw,
                                         opt.min_chain_score * 2)
        else:
            as1, cnt1 = r.as_, r.cnt
        filter_bad_seeds(as1, cnt1, ax, ay, 10, 40, opt.max_gap >> 1, 10)
        filter_bad_seeds_alt(as1, cnt1, ax, ay, 30, opt.max_gap >> 1)
        rs, qs = adjust_minier(mi, qseq0, ax[as1], ay[as1])
        re, qe = adjust_minier(mi, qseq0, ax[as1 + cnt1 - 1], ay[as1 + cnt1 - 1])
    assert cnt1 > 0

    extra_flag = 0
    if is_splice:  # (reference align.c:602-605)
        if splice_flag & MM_F_SPLICE_FOR:
            extra_flag |= EZ_SPLICE_REV if rev else EZ_SPLICE_FOR
        if splice_flag & MM_F_SPLICE_REV:
            extra_flag |= EZ_SPLICE_FOR if rev else EZ_SPLICE_REV
        if opt.flag & MM_F_SPLICE_FLANK:
            extra_flag |= EZ_SPLICE_FLANK

    # DP region bounds (reference align.c:608-684)
    tlen_rid = mi.seqs[rid].length
    if is_sr:
        qs0, qe0 = 0, qlen
        l = qs
        l += (l * opt.a + opt.end_bonus - opt.q) // opt.e if l * opt.a + opt.end_bonus > opt.q else 0
        rs0 = rs - l if rs - l > 0 else 0
        l = qlen - qe
        l += (l * opt.a + opt.end_bonus - opt.q) // opt.e if l * opt.a + opt.end_bonus > opt.q else 0
        re0 = re + l if re + l < tlen_rid else tlen_rid
    else:
        rs0 = _i32(ax[r.as_]) + 1 - int(ay[r.as_] >> U64(32) & U64(0xFF))
        qs0 = _i32(ay[r.as_]) + 1 - int(ay[r.as_] >> U64(32) & U64(0xFF))
        if rs0 < 0:
            rs0 = 0
        assert qs0 >= 0
        rs1 = qs1 = 0
        i = r.as_ - 1
        l = 0
        while i >= 0 and int(ax[i] >> U64(32)) == int(ax[r.as_] >> U64(32)):
            x = _i32(ax[i]) + 1 - int(ay[i] >> U64(32) & U64(0xFF))
            y = _i32(ay[i]) + 1 - int(ay[i] >> U64(32) & U64(0xFF))
            if x < rs0 and y < qs0:
                l += 1
                if l > opt.min_cnt:
                    ll = max(rs0 - x, qs0 - y)
                    rs1, qs1 = rs0 - ll, qs0 - ll
                    if rs1 < 0:
                        rs1 = 0
                    break
            i -= 1
        if qs > 0 and rs > 0:
            l = min(qs, opt.max_gap)
            qs1 = max(qs1, qs - l)
            qs0 = min(qs0, qs1)
            l += (l * opt.a - opt.q) // opt.e if l * opt.a > opt.q else 0
            l = min(l, opt.max_gap)
            l = min(l, rs)
            rs1 = max(rs1, rs - l)
            rs0 = min(rs0, rs1)
            rs0 = min(rs0, rs)
        else:
            rs0, qs0 = rs, qs
        re0 = _i32(ax[r.as_ + r.cnt - 1]) + 1
        qe0 = _i32(ay[r.as_ + r.cnt - 1]) + 1
        re1, qe1 = tlen_rid, qlen
        i = r.as_ + r.cnt
        l = 0
        while i < n_a and int(ax[i] >> U64(32)) == int(ax[r.as_] >> U64(32)):
            x = _i32(ax[i]) + 1
            y = _i32(ay[i]) + 1
            if x > re0 and y > qe0:
                l += 1
                if l > opt.min_cnt:
                    ll = max(x - re0, y - qe0)
                    re1, qe1 = re0 + ll, qe0 + ll
                    break
            i += 1
        if qe < qlen and re < tlen_rid:
            l = min(qlen - qe, opt.max_gap)
            qe1 = min(qe1, qe + l)
            qe0 = max(qe0, qe1)
            l += (l * opt.a - opt.q) // opt.e if l * opt.a > opt.q else 0
            l = min(l, opt.max_gap)
            l = min(l, tlen_rid - re)
            re1 = min(re1, re + l)
            re0 = max(re0, re1)
        else:
            re0, qe0 = re, qe
    if int(ay[r.as_]) & MM_SEED_SELF:
        max_ext = abs(r.qs - r.rs)
        if r.rs - rs0 > max_ext:
            rs0 = r.rs - max_ext
        if r.qs - qs0 > max_ext:
            qs0 = r.qs - max_ext
        max_ext = abs(r.qe - r.re)
        if re0 - r.re > max_ext:
            re0 = r.re + max_ext
        if qe0 - r.qe > max_ext:
            qe0 = r.qe + max_ext

    assert re0 > rs0
    dropped = False
    qseq_dir = qseq0[rev]
    junc_all = None
    if is_splice and mi.intervals:
        junc_all = bed_junc(mi, rid, rs0, re0)

    def _junc(a, b):  # junction flags over reference window [a, b)
        if junc_all is None:
            return None
        return junc_all[a - rs0:b - rs0]

    if qs > 0 and rs > 0:  # left extension
        qseq = JobSeq(qseq_dir[qs0:qs], rev=True)
        tseq = JobSeq(mi.getseq(rid, rs0, rs), rev=True)
        jl = _junc(rs0, rs)
        ez = yield (
            opt, qseq, tseq, mat, bw, opt.end_bonus,
            opt.zdrop_inv if r.split_inv else opt.zdrop,
            extra_flag | EZ_EXTZ_ONLY | EZ_RIGHT | EZ_REV_CIGAR,
            jl[::-1].copy() if jl is not None else None,
        )
        if len(ez.cigar) > 0:
            _append_cigar(r, ez.cigar)
            r.p.dp_score += ez.max
        rs1 = rs - (ez.mqe_t + 1 if ez.reach_end else ez.max_t + 1)
        qs1 = qs - (qs - qs0 if ez.reach_end else ez.max_q + 1)
    else:
        rs1, qs1 = rs, qs
    re1, qe1 = rs, qs
    assert qs1 >= 0 and rs1 >= 0

    # Gap filling between anchors (reference align.c:665-770), restructured
    # for batch execution: the segment boundaries depend only on the anchors
    # (never on DP results), so every fill segment of the chain is
    # enumerated first and yielded as ONE job group; the results are then
    # consumed sequentially with the reference's exact two-pass z-drop /
    # split semantics (a z-dropped segment discards the speculative work of
    # the segments after it, exactly like the reference's loop break).
    segs = []  # (i, qs, qe, rs, re, bw1)
    rs_e, qs_e = rs, qs
    re_e = qe_e = None
    i = cnt1 - 1 if is_sr else 1
    while i < cnt1:
        if (int(ay[as1 + i]) & (MM_SEED_IGNORE | MM_SEED_TANDEM)) and i != cnt1 - 1:
            i += 1
            continue
        if is_sr and not (mi.flag & 1):
            re_e = _i32(ax[as1 + i]) + 1
            qe_e = _i32(ay[as1 + i]) + 1
        else:
            re_e, qe_e = adjust_minier(mi, qseq0, ax[as1 + i], ay[as1 + i])
        if i == cnt1 - 1 or (int(ay[as1 + i]) & MM_SEED_LONG_JOIN) or (
            qe_e - qs_e >= opt.min_ksw_len and re_e - rs_e >= opt.min_ksw_len
        ):
            bw1 = bw
            if int(ay[as1 + i]) & MM_SEED_LONG_JOIN:
                bw1 = max(qe_e - qs_e, re_e - rs_e)
            segs.append((i, qs_e, qe_e, rs_e, re_e, bw1))
            rs_e, qs_e = re_e, qe_e
        i += 1

    if segs and not is_sr:
        ezs = yield [
            (opt, JobSeq(qseq_dir[sqs:sqe]), JobSeq(mi.getseq(rid, srs, sre)),
             mat, bw1, -1, opt.zdrop, extra_flag | EZ_APPROX_MAX,
             _junc(srs, sre))
            for (_, sqs, sqe, srs, sre, bw1) in segs
        ]
    else:
        ezs = []

    for si, (i, qs, qe, rs, re, bw1) in enumerate(segs):
        # NB: inside this loop rs/qs/re/qe take each segment's bounds, and
        # after it they hold the last segment's end coords, matching the
        # incremental updates of the reference loop.
        qseq = qseq_dir[qs:qe]
        tseq = mi.getseq(rid, rs, re)
        if is_sr:  # ungapped
            assert qe - qs == re - rs
            score = 0
            for j in range(qe - qs):
                if qseq[j] >= 4 or tseq[j] >= 4:
                    score += opt.e2
                else:
                    score += opt.a if qseq[j] == tseq[j] else -opt.b
            ez = native.ExtResult.__new__(native.ExtResult)
            ez.score = score
            ez.zdropped = False
            ez.cigar = np.array([(qe - qs) << 4], dtype=np.uint32)
            ez.max = 0
            ez.max_q = ez.max_t = -1
            ez.reach_end = False
            zdrop_code = 0
        else:
            ez = ezs[si]
            zdrop_code = test_zdrop(opt, qseq, tseq, ez.cigar, mat)
            if zdrop_code != 0:
                ez = yield (
                    opt, JobSeq(qseq), JobSeq(tseq), mat, bw1, -1,
                    opt.zdrop_inv if zdrop_code == 2 else opt.zdrop,
                    extra_flag, _junc(rs, re),
                )
        if len(ez.cigar) > 0:
            _append_cigar(r, ez.cigar)
        if ez.zdropped:
            if r.p is None:
                r.p = Extra()
            j = i - 1
            while j >= 0:
                if _i32(ax[as1 + j]) <= rs + ez.max_t:
                    break
                j -= 1
            dropped = True
            if j < 0:
                j = 0
            r.p.dp_score += ez.max
            re1 = rs + (ez.max_t + 1)
            qe1 = qs + (ez.max_q + 1)
            if cnt1 - (j + 1) >= opt.min_cnt:
                r2 = split_reg(r, as1 + j + 1 - r.as_, qlen, ax, ay)
                if r2 is not None and zdrop_code == 2:
                    r2.split_inv = True
            break
        else:
            r.p.dp_score += ez.score
    if not dropped:
        # reference post-loop state: rs/qs advanced to the last filled
        # segment's end; re/qe hold the last non-skipped anchor's coords
        if segs:
            rs, qs = segs[-1][4], segs[-1][2]
        if re_e is not None:
            re, qe = re_e, qe_e
            re1, qe1 = re_e, qe_e

    if not dropped and qe < qe0 and re < re0:  # right extension
        qseq = qseq_dir[qe:qe0]
        tseq = mi.getseq(rid, re, re0)
        ez = yield (
            opt, JobSeq(qseq), JobSeq(tseq), mat, bw, opt.end_bonus,
            opt.zdrop, extra_flag | EZ_EXTZ_ONLY, _junc(re, re0),
        )
        if len(ez.cigar) > 0:
            _append_cigar(r, ez.cigar)
            r.p.dp_score += ez.max
        re1 = re + (ez.mqe_t + 1 if ez.reach_end else ez.max_t + 1)
        qe1 = qe + (qe0 - qe if ez.reach_end else ez.max_q + 1)
    assert qe1 <= qlen

    r.rs, r.re = rs1, re1
    if rev:
        r.qs = qlen - qe1
        r.qe = qlen - qs1
    else:
        r.qs, r.qe = qs1, qe1

    assert re1 - rs1 <= re0 - rs0
    if r.p is not None:
        tseq = mi.getseq(rid, rs1, re1)
        update_extra(r, qseq0[1 if r.rev else 0][qs1:], tseq, mat, opt.q, opt.e,
                     opt.flag & MM_F_EQX)
        if rev and r.p.trans_strand:
            r.p.trans_strand ^= 3
    return r2, dropped


def align1_inv_gen(opt, mi, qlen, qseq0, r1: Reg, r2: Reg):
    """Attempt inversion alignment between two split regions
    (reference mm_align1_inv, align.c:797-852)."""
    if not (r1.split & 1) or not (r2.split & 2):
        return None
    if r1.id != r1.parent and r1.parent != MM_PARENT_TMP_PRI:
        return None
    if r2.id != r2.parent and r2.parent != MM_PARENT_TMP_PRI:
        return None
    if r1.rid != r2.rid or r1.rev != r2.rev:
        return None
    ql = r1.qs - r2.qe if r1.rev else r2.qs - r1.qe
    tl = r2.rs - r1.re
    if ql < opt.min_chain_score or ql > opt.max_gap:
        return None
    if tl < opt.min_chain_score or tl > opt.max_gap:
        return None
    mat = gen_simple_mat(opt.a, opt.b, opt.sc_ambi)
    tseq = mi.getseq(r1.rid, r1.re, r2.rs)
    # views into the read pool, so the job below resolves to it
    if r1.rev:
        qseq = qseq0[0][r2.qe : r2.qe + ql]
    else:
        qseq = qseq0[1][qlen - r2.qs : qlen - r2.qs + ql]
    sc, q_off, t_off = native.sw_score(qseq[::-1].copy(), tseq[::-1].copy(), mat, opt.q, opt.e)
    if sc < opt.min_dp_max:
        return None
    q_off = ql - (q_off + 1)
    t_off = tl - (t_off + 1)
    ez = yield (
        opt, JobSeq(qseq[q_off:]), JobSeq(tseq[t_off:]), mat,
        int(opt.bw * 1.5), -1, opt.zdrop, EZ_EXTZ_ONLY,
    )
    if len(ez.cigar) == 0:
        return None
    r_inv = Reg()
    _append_cigar(r_inv, ez.cigar)
    r_inv.p.dp_score = ez.max
    r_inv.id = -1
    r_inv.parent = MM_PARENT_UNSET
    r_inv.inv = True
    r_inv.rev = not r1.rev
    r_inv.rid = r1.rid
    r_inv.div = -1.0
    if not r_inv.rev:
        r_inv.qs = r2.qe + q_off
        r_inv.qe = r_inv.qs + ez.max_q + 1
    else:
        r_inv.qe = r2.qs - q_off
        r_inv.qs = r_inv.qe - (ez.max_q + 1)
    r_inv.rs = r1.re + t_off
    r_inv.re = r_inv.rs + ez.max_t + 1
    update_extra(r_inv, qseq[q_off:], tseq[t_off:], mat, opt.q, opt.e,
                 opt.flag & MM_F_EQX)
    return r_inv


def align_skeleton_gen(opt, mi, qlen, regs: list[Reg], ax, ay, qseq0):
    """Align all chains of one read (reference mm_align_skeleton,
    align.c:864-920).  qseq0 holds the read's (fwd, rev) strand codes as
    views into the read pool."""
    n_a, ax, ay = squeeze_a(regs, ax, ay)
    i = 0
    while i < len(regs):
        if (opt.flag & MM_F_SPLICE) and (opt.flag & MM_F_SPLICE_FOR) and (
                opt.flag & MM_F_SPLICE_REV):
            # two rounds, one per transcript strand (reference
            # align.c:884-900)
            cand = [copy.copy(regs[i]), copy.copy(regs[i])]
            r2s = [None, None]
            r2s[0], _ = yield from align1_gen(opt, mi, qlen, qseq0, cand[0],
                                              n_a, ax, ay, MM_F_SPLICE_FOR)
            r2s[1], _ = yield from align1_gen(opt, mi, qlen, qseq0, cand[1],
                                              n_a, ax, ay, MM_F_SPLICE_REV)
            sc0 = cand[0].p.dp_score if cand[0].p else -(1 << 30)
            sc1 = cand[1].p.dp_score if cand[1].p else -(1 << 30)
            if sc0 > sc1:
                which, trans_strand = 0, 1
            elif sc0 < sc1:
                which, trans_strand = 1, 2
            else:
                trans_strand = 3
                which = (qlen + sc0) & 1
            regs[i] = cand[which]
            r2 = r2s[which]
            if regs[i].p is not None:
                regs[i].p.trans_strand = trans_strand
        else:
            r2, _ = yield from align1_gen(opt, mi, qlen, qseq0, regs[i], n_a,
                                          ax, ay, opt.flag)
            if (opt.flag & MM_F_SPLICE) and regs[i].p is not None:
                regs[i].p.trans_strand = \
                    1 if opt.flag & MM_F_SPLICE_FOR else 2
        if r2 is not None and r2.cnt > 0:
            regs.insert(i + 1, r2)
        if i > 0 and regs[i].split_inv:
            r_inv = yield from align1_inv_gen(opt, mi, qlen, qseq0,
                                              regs[i - 1], regs[i])
            if r_inv is not None:
                regs.insert(i + 1, r_inv)
                i += 1
        i += 1
    regs = filter_regs(opt, qlen, regs)
    regs = hit_sort(regs, opt.alt_drop)
    return regs, ax, ay
