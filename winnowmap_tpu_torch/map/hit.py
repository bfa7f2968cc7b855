"""Chains -> alignment records and primary/secondary bookkeeping
(reference src/hit.c): region generation, parent assignment, secondary
selection, long-join over SVs, filtering, sorting, and the MAPQ model.
Float arithmetic runs in float32 to match the reference's C floats.

The generator mapping path (map/frag.py, map/align.py) runs these on the
host; the native engine has its own copy, and the SAM/PAF writers read the
Reg/Extra records of both.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..options import MM_SEED_LONG_JOIN, MM_SEED_SEG_SHIFT

MM_PARENT_UNSET = -1
MM_PARENT_TMP_PRI = -2

U64 = np.uint64
f32 = np.float32


@dataclass
class Extra:
    """Alignment detail (reference mm_extra_t, minimap.h:79-86)."""

    dp_score: int = 0
    dp_max: int = 0
    dp_max2: int = 0
    n_ambi: int = 0
    trans_strand: int = 0
    cigar: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))


@dataclass
class Reg:
    """One alignment region (reference mm_reg1_t, minimap.h:88-103)."""

    id: int = 0
    cnt: int = 0
    rid: int = 0
    score: int = 0
    qs: int = 0
    qe: int = 0
    rs: int = 0
    re: int = 0
    parent: int = MM_PARENT_UNSET
    subsc: int = 0
    as_: int = 0
    mlen: int = 0
    blen: int = 0
    n_sub: int = 0
    score0: int = 0
    mapq: int = 0
    div: float = -1.0
    inv: bool = False
    rev: bool = False
    split: int = 0
    split_inv: bool = False
    sam_pri: bool = False
    proper_frag: bool = False
    pe_thru: bool = False
    seg_split: bool = False
    seg_id: int = 0
    n_segs: int = 1
    is_alt: bool = False
    hash: int = 0
    p: Extra | None = None


def _hash64(key: int) -> int:
    """Invertible 64-bit mix, unmasked (reference hit.c:40-50)."""
    M = 0xFFFFFFFFFFFFFFFF
    key = (~key + (key << 21)) & M
    key = key ^ key >> 24
    key = ((key + (key << 3)) + (key << 8)) & M
    key = key ^ key >> 14
    key = ((key + (key << 2)) + (key << 4)) & M
    key = key ^ key >> 28
    key = (key + (key << 31)) & M
    return key


def _cal_fuzzy_len(r: Reg, ax, ay) -> None:
    """(reference mm_cal_fuzzy_len, hit.c:8-21)"""
    r.mlen = r.blen = 0
    if r.cnt <= 0:
        return
    a0, a1 = r.as_, r.as_ + r.cnt
    spans = ((ay[a0:a1] >> U64(32)) & U64(0xFF)).astype(np.int64)
    axi = ax[a0:a1].astype(np.uint32).astype(np.int32).astype(np.int64)
    ayi = ay[a0:a1].astype(np.uint32).astype(np.int32).astype(np.int64)
    tl = np.diff(axi)
    ql = np.diff(ayi)
    sp = spans[1:]
    blen = int(spans[0] + np.maximum(tl, ql).sum())
    mlen = int(spans[0] + np.where((tl > sp) & (ql > sp), sp,
                                   np.minimum(tl, ql)).sum())
    r.blen = blen
    r.mlen = mlen


def _i32(v) -> int:
    """(int32_t)x of a uint64 payload."""
    x = int(v) & 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def reg_set_coor(r: Reg, qlen: int, ax, ay) -> None:
    """(reference mm_reg_set_coor, hit.c:23-38)"""
    k = r.as_
    q_span = int(ay[k] >> U64(32) & U64(0xFF))
    r.rev = bool(ax[k] >> U64(63))
    r.rid = int(ax[k] << U64(1) >> U64(33))
    rs = _i32(ax[k]) + 1 - q_span
    r.rs = rs if rs > 0 else 0
    r.re = _i32(ax[k + r.cnt - 1]) + 1
    if not r.rev:
        r.qs = _i32(ay[k]) + 1 - q_span
        r.qe = _i32(ay[k + r.cnt - 1]) + 1
    else:
        r.qs = qlen - (_i32(ay[k + r.cnt - 1]) + 1)
        r.qe = qlen - (_i32(ay[k]) + 1 - q_span)
    _cal_fuzzy_len(r, ax, ay)


def gen_regs(hash_: int, qlen: int, u: np.ndarray, ax, ay) -> list[Reg]:
    """Chains -> regs, sorted by score with hashed tie-break
    (reference mm_gen_regs, hit.c:52-88)."""
    n_u = len(u)
    if n_u == 0:
        return []
    zx = np.empty(n_u, dtype=np.uint64)
    zy_as = np.empty(n_u, dtype=np.int64)
    zy_cnt = np.empty(n_u, dtype=np.int64)
    k = 0
    for i in range(n_u):
        h = _hash64((_hash64(int(ax[k])) + _hash64(int(ay[k]))) ^ (hash_ & 0xFFFFFFFFFFFFFFFF)) & 0xFFFFFFFF
        zx[i] = U64(int(u[i]) ^ h)
        zy_as[i] = k
        zy_cnt[i] = _i32(u[i])
        k += _i32(u[i])
    order = np.argsort(zx, kind="stable")[::-1]
    regs = []
    for i, oi in enumerate(order):
        r = Reg()
        r.id = i
        r.parent = MM_PARENT_UNSET
        r.score = r.score0 = int(zx[oi] >> U64(32))
        r.hash = int(zx[oi] & U64(0xFFFFFFFF))
        r.cnt = int(zy_cnt[oi])
        r.as_ = int(zy_as[oi])
        r.div = -1.0
        reg_set_coor(r, qlen, ax, ay)
        regs.append(r)
    return regs


def seg_gen(hash_: int, qlens: list[int], regs0: list[Reg], ax, ay):
    """Split a fragment's chains into per-segment chains (reference
    mm_seg_gen, hit.c:373-435).  Anchors carry their segment id in y bits
    48-55 (mmpriv.h MM_SEED_SEG_SHIFT); each segment's anchor positions are
    rebased from concatenated-fragment coordinates to segment-local ones.
    Returns per segment: (regs, ax, ay)."""
    n_segs = len(qlens)
    acc = [0]
    for q in qlens[:-1]:
        acc.append(acc[-1] + q)
    qlen_sum = acc[-1] + qlens[-1]

    sid_of = ((ay >> U64(MM_SEED_SEG_SHIFT)) & U64(0xFF)).astype(np.int64)
    out = []
    for s in range(n_segs):
        u_s = []
        idx_s = []
        for r in regs0:
            sl = slice(r.as_, r.as_ + r.cnt)
            mine = np.flatnonzero(sid_of[sl] == s) + r.as_
            if len(mine):  # squeeze out zero-length per-segment chains
                u_s.append((r.score << 32) | len(mine))
                idx_s.append(mine)
        if idx_s:
            take = np.concatenate(idx_s)
            ax_s = ax[take]
            ay_s = ay[take].copy()
            # rebase positions: reverse-strand anchors measure from the
            # concatenated fragment's 3' end (see hit.c:407-414 derivation)
            rev = (ax_s >> U64(63)).astype(bool)
            shift_f = U64(acc[s])
            shift_r = U64(qlen_sum - (qlens[s] + acc[s]))
            ay_s = np.where(rev, ay_s - shift_r, ay_s - shift_f)
        else:
            ax_s = np.zeros(0, np.uint64)
            ay_s = np.zeros(0, np.uint64)
        regs_s = gen_regs(hash_, qlens[s], np.array(u_s, np.uint64),
                          ax_s, ay_s)
        for r in regs_s:
            r.seg_split = True
            r.seg_id = s
            r.n_segs = n_segs
        out.append((regs_s, ax_s, ay_s))
    return out


def split_reg(r: Reg, n: int, qlen: int, ax, ay) -> Reg | None:
    """Split region at anchor n after a z-drop (reference mm_split_reg,
    hit.c:106-123)."""
    if n <= 0 or n >= r.cnt:
        return None
    r2 = Reg(**{f: getattr(r, f) for f in r.__dataclass_fields__})
    r2.id = -1
    r2.sam_pri = False
    r2.p = None
    r2.split_inv = False
    r2.cnt = r.cnt - n
    r2.score = int(r.score * (r2.cnt / r.cnt) + 0.499)
    r2.as_ = r.as_ + n
    if r.parent == r.id:
        r2.parent = MM_PARENT_TMP_PRI
    reg_set_coor(r2, qlen, ax, ay)
    r.cnt -= r2.cnt
    r.score -= r2.score
    reg_set_coor(r, qlen, ax, ay)
    r.split |= 1
    r2.split |= 2
    return r2


def _alt_score(score: int, alt_diff_frac: float) -> int:
    if score < 0:
        return score
    score = int(score * (1.0 - alt_diff_frac) + 0.499)
    return score if score > 0 else 1


def set_parent(mask_level: float, mask_len: int, regs: list[Reg], sub_diff: int,
               hard_mask_level: int, alt_diff_frac: float) -> None:
    """Primary/secondary assignment by query-interval overlap
    (reference mm_set_parent, hit.c:125-186)."""
    n = len(regs)
    if n <= 0:
        return
    for i, r in enumerate(regs):
        r.id = i
    w = [0]
    regs[0].parent = 0
    for i in range(1, n):
        ri = regs[i]
        si, ei = ri.qs, ri.qe
        uncov_len = 0
        j_break = None
        if not hard_mask_level:
            cov = []
            for j in range(len(w)):
                rp = regs[w[j]]
                sj, ej = rp.qs, rp.qe
                if ej <= si or sj >= ei:
                    continue
                cov.append((max(sj, si), min(ej, ei)))
            if cov:
                cov.sort()
                x = si
                for cs, ce in cov:
                    if cs > x:
                        uncov_len += cs - x
                    x = max(ce, x)
                if ei > x:
                    uncov_len += ei - x
            # if no overlapping primary, fall through to parent test with
            # j == len(w)
        for j in range(len(w)):
            rp = regs[w[j]]
            sj, ej = rp.qs, rp.qe
            if ej <= si or sj >= ei:
                continue
            min_ = min(ej - sj, ei - si)
            max_ = max(ej - sj, ei - si)
            if si < sj:
                ol = 0 if ei < sj else (ei - sj if ei < ej else ej - sj)
            else:
                ol = 0 if ej < si else (ej - si if ej < ei else ei - si)
            if (
                f32(ol) / f32(min_) - f32(uncov_len) / f32(max_) > f32(mask_level)
                and uncov_len <= mask_len
            ):
                cnt_sub = 0
                sci = ri.score
                ri.parent = rp.parent
                if not rp.is_alt and ri.is_alt:
                    sci = _alt_score(sci, alt_diff_frac)
                rp.subsc = max(rp.subsc, sci)
                if ri.cnt >= rp.cnt:
                    cnt_sub = 1
                if rp.p is not None and ri.p is not None and (
                    rp.rid != ri.rid or rp.rs != ri.rs or rp.re != ri.re or ol != min_
                ):
                    sci = ri.p.dp_max
                    if not rp.is_alt and ri.is_alt:
                        sci = _alt_score(sci, alt_diff_frac)
                    rp.p.dp_max2 = max(rp.p.dp_max2, sci)
                    if rp.p.dp_max - ri.p.dp_max <= sub_diff:
                        cnt_sub = 1
                if cnt_sub:
                    rp.n_sub += 1
                j_break = j
                break
        if j_break is None:
            w.append(i)
            ri.parent = i
            ri.n_sub = 0


def hit_sort(regs: list[Reg], alt_diff_frac: float) -> list[Reg]:
    """Sort hits by (DP or chain) score desc with hash tie-break
    (reference mm_hit_sort, hit.c:188-218); drops soft-deleted regions."""
    if len(regs) <= 1:
        return [r for r in regs if r.inv or r.cnt > 0]
    aux = []
    for i, r in enumerate(regs):
        if r.inv or r.cnt > 0:
            score = r.p.dp_max if r.p is not None else r.score
            if r.is_alt:
                score = _alt_score(score, alt_diff_frac)
            aux.append(((score & 0xFFFFFFFF) << 32 | r.hash, i))
    aux.sort(key=lambda t: t[0])
    return [regs[i] for _, i in reversed(aux)]


def set_sam_pri(regs: list[Reg]) -> int:
    n_pri = 0
    for r in regs:
        if r.id == r.parent:
            n_pri += 1
            r.sam_pri = n_pri == 1
        else:
            r.sam_pri = False
    return n_pri


def sync_regs(regs: list[Reg]) -> None:
    """Re-pack ids and remap parents (reference mm_sync_regs, hit.c:231-253)."""
    if not regs:
        return
    max_id = max(r.id for r in regs)
    tmp = [-1] * (max_id + 1)
    for i, r in enumerate(regs):
        if r.id >= 0:
            tmp[r.id] = i
    for i, r in enumerate(regs):
        r.id = i
        if r.parent == MM_PARENT_TMP_PRI:
            r.parent = i
        elif r.parent >= 0 and tmp[r.parent] >= 0:
            r.parent = tmp[r.parent]
        else:
            r.parent = MM_PARENT_UNSET
    set_sam_pri(regs)


def select_sub(pri_ratio: float, min_diff: int, best_n: int, regs: list[Reg]) -> list[Reg]:
    """Secondary filtering (reference mm_select_sub, hit.c:255-272)."""
    if pri_ratio <= 0.0 or not regs:
        return regs
    out = []
    n_2nd = 0
    for i, r in enumerate(regs):
        p = r.parent
        if p == i or r.inv:
            out.append(r)
        elif (
            r.score >= regs[p].score * pri_ratio or r.score + min_diff >= regs[p].score
        ) and n_2nd < best_n:
            if not (
                r.qs == regs[p].qs
                and r.qe == regs[p].qe
                and r.rid == regs[p].rid
                and r.rs == regs[p].rs
                and r.re == regs[p].re
            ):
                out.append(r)
                n_2nd += 1
    if len(out) != len(regs):
        sync_regs(out)
    return out


def filter_regs(opt, qlen: int, regs: list[Reg]) -> list[Reg]:
    """(reference mm_filter_regs, hit.c:274-293)"""
    out = []
    for r in regs:
        flt = False
        if not r.inv and not r.seg_split and r.cnt < opt.min_cnt:
            flt = True
        if r.p is not None:
            if r.mlen < opt.min_chain_score:
                flt = True
            elif r.p.dp_max < opt.min_dp_max:
                flt = True
            elif r.qs > qlen * opt.max_clip_ratio and qlen - r.qe > qlen * opt.max_clip_ratio:
                flt = True
        if not flt:
            out.append(r)
    return out


def squeeze_a(regs: list[Reg], ax, ay):
    """Compact the anchor array to just the referenced runs
    (reference mm_squeeze_a, hit.c:295-313).  Returns (n_a, ax, ay)."""
    aux = sorted(range(len(regs)), key=lambda i: (regs[i].as_ << 32 | i))
    as_ = 0
    for i in aux:
        r = regs[i]
        if r.as_ != as_:
            ax[as_ : as_ + r.cnt] = ax[r.as_ : r.as_ + r.cnt].copy()
            ay[as_ : as_ + r.cnt] = ay[r.as_ : r.as_ + r.cnt].copy()
            r.as_ = as_
        as_ += r.cnt
    return as_, ax, ay


def join_long(opt, qlen: int, regs: list[Reg], ax, ay) -> list[Reg]:
    """Join adjacent colinear chains across long SV gaps
    (reference mm_join_long, hit.c:315-371)."""
    if len(regs) < 2:
        return regs
    squeeze_a(regs, ax, ay)
    aux = sorted(
        (i for i in range(len(regs)) if regs[i].parent == i or regs[i].parent < 0),
        key=lambda i: (regs[i].as_ << 32 | i),
    )
    n_drop = 0
    for idx in range(len(aux) - 1, 0, -1):
        r0 = regs[aux[idx - 1]]
        r1 = regs[aux[idx]]
        if r0.as_ + r0.cnt != r1.as_:
            continue
        if r0.rid != r1.rid or r0.rev != r1.rev:
            continue
        a0e_x, a0e_y = int(ax[r0.as_ + r0.cnt - 1]), int(ay[r0.as_ + r0.cnt - 1])
        a1s_x, a1s_y = int(ax[r1.as_]), int(ay[r1.as_])
        if a1s_x <= a0e_x or _i32(a1s_y) <= _i32(a0e_y):
            continue
        gap_q = _i32(a1s_y) - _i32(a0e_y)
        max_gap = min_gap = gap_q
        max_gap = max_gap if a0e_x + max_gap > a1s_x else a1s_x - a0e_x
        min_gap = min_gap if a0e_x + min_gap < a1s_x else a1s_x - a0e_x
        if max_gap > opt.max_join_long or min_gap > opt.max_join_short:
            continue
        sc_thres = int(float(f32(opt.min_join_flank_sc) / f32(opt.max_join_long) * f32(max_gap)) + 0.499)
        if r0.score < sc_thres or r1.score < sc_thres:
            continue
        min_flank_len = int(max_gap * opt.min_join_flank_ratio)
        if r0.re - r0.rs < min_flank_len or r0.qe - r0.qs < min_flank_len:
            continue
        if r1.re - r1.rs < min_flank_len or r1.qe - r1.qs < min_flank_len:
            continue
        ay[r1.as_] = U64(int(ay[r1.as_]) | MM_SEED_LONG_JOIN)
        r0.cnt += r1.cnt
        r0.score += r1.score
        reg_set_coor(r0, qlen, ax, ay)
        r1.cnt = 0
        r1.parent = r0.id
        n_drop += 1
    if n_drop > 0:
        for r in regs:
            if r.parent >= 0 and r.id != r.parent:
                pp = regs[r.parent].parent
                if pp >= 0 and pp != r.parent:
                    r.parent = pp
        regs = filter_regs(opt, qlen, regs)
        sync_regs(regs)
    return regs


def _set_inv_mapq(regs: list[Reg]) -> None:
    """(reference mm_set_inv_mapq, hit.c:437-461)"""
    n = len(regs)
    if n < 3 or not any(r.inv for r in regs):
        return
    aux = sorted(
        (i for i in range(n) if regs[i].parent == i or regs[i].parent < 0),
        key=lambda i: (regs[i].rid << 32 | regs[i].rs, i),
    )
    for k in range(1, len(aux) - 1):
        inv = regs[aux[k]]
        if inv.inv:
            l, r = regs[aux[k - 1]], regs[aux[k + 1]]
            inv.mapq = min(l.mapq, r.mapq)


def set_mapq(regs: list[Reg], min_chain_sc: int, match_sc: int, rep_len: int,
             is_sr: bool) -> None:
    """MAPQ model (reference mm_set_mapq, hit.c:463-508), float32 semantics."""
    if not regs:
        return
    q_coef = f32(40.0)
    sum_sc = 0
    for r in regs:
        if r.parent == r.id:
            sum_sc += r.score
    uniq_ratio = f32(sum_sc) / f32(sum_sc + rep_len) if (sum_sc + rep_len) else f32(0)
    for r in regs:
        if r.inv:
            r.mapq = 0
        elif r.parent == r.id:
            pen_s1 = (f32(1.0) if r.score > 100 else f32(0.01) * f32(r.score)) * uniq_ratio
            pen_cm = f32(1.0) if r.cnt > 10 else f32(0.1) * f32(r.cnt)
            pen_cm = pen_s1 if pen_s1 < pen_cm else pen_cm
            subsc = r.subsc if r.subsc > min_chain_sc else min_chain_sc
            if r.p is not None and r.p.dp_max2 > 0 and r.p.dp_max > 0:
                identity = f32(r.mlen) / f32(r.blen)
                x = f32(r.p.dp_max2) * f32(subsc) / f32(r.p.dp_max) / f32(r.score0)
                mapq = int(
                    identity * pen_cm * q_coef * (f32(1.0) - x * x)
                    * f32(np.log(f32(r.p.dp_max) / f32(match_sc)))
                )
                if not is_sr:
                    mapq_alt = int(
                        f32(6.02) * identity * identity
                        * f32(r.p.dp_max - r.p.dp_max2) / f32(match_sc) + f32(0.499)
                    )
                    mapq = min(mapq, mapq_alt)
            else:
                x = f32(subsc) / f32(r.score0)
                if r.p is not None:
                    identity = f32(r.mlen) / f32(r.blen)
                    mapq = int(
                        identity * pen_cm * q_coef * (f32(1.0) - x)
                        * f32(np.log(f32(r.p.dp_max) / f32(match_sc)))
                    )
                else:
                    mapq = int(pen_cm * q_coef * (f32(1.0) - x) * f32(np.log(f32(r.score))))
            mapq -= int(f32(4.343) * f32(np.log(f32(r.n_sub + 1))) + f32(0.499))
            mapq = max(mapq, 0)
            r.mapq = min(mapq, 60)
            if r.p is not None and r.p.dp_max > r.p.dp_max2 and r.mapq == 0:
                r.mapq = 1
        else:
            r.mapq = 0
    _set_inv_mapq(regs)
