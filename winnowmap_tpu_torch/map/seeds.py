"""Query sketching and seed-hit collection (reference map.c:69-254)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native
from ..options import (
    MM_F_FOR_ONLY,
    MM_F_NO_DIAG,
    MM_F_NO_DUAL,
    MM_F_REV_ONLY,
    MM_SEED_SEG_SHIFT,
    MM_SEED_SELF,
    MM_SEED_TANDEM,
)
from ..utils import dbg


def collect_minimizers(opt, mi, qlens, seqs):
    """Sketch all segments of a fragment (reference collect_minimizers,
    map.c:69-84).  Returns (x, y) with the per-segment query-length offset
    folded into y's position field."""
    xs, ys = [], []
    total = 0
    for i, (qlen, seq) in enumerate(zip(qlens, seqs)):
        x, y = native.sketch(seq, mi.w, mi.k, i, bool(mi.flag & 1), mi.wset,
                             bloom=getattr(mi, "bloom", None))
        if opt.sdust_thres > 0:
            x, y = dust_minimizers(x, y, seq, opt.sdust_thres)
        y = y + np.uint64(total << 1)
        xs.append(x)
        ys.append(y)
        total += qlen
    if xs:
        return np.concatenate(xs), np.concatenate(ys)
    return np.zeros(0, np.uint64), np.zeros(0, np.uint64)


def dust_minimizers(x, y, seq, sdust_thres):
    """Drop minimizers mostly inside low-complexity regions (reference
    mm_dust_minier, map.c:43-67: keep if at most half the span is masked)."""
    dreg = native.sdust(seq, sdust_thres, 64)
    if len(dreg) == 0 or len(x) == 0:
        return x, y
    ds = (dreg >> np.uint64(32)).astype(np.int64)
    de = (dreg & np.uint64(0xFFFFFFFF)).astype(np.int64)
    qpos = ((y & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
    span = (x & np.uint64(0xFF)).astype(np.int64)
    s = qpos - (span - 1)
    e = s + span
    keep = np.ones(len(x), dtype=bool)
    for j in range(len(x)):
        lo = np.searchsorted(de, s[j], side="right")
        l = 0
        v = lo
        while v < len(ds) and ds[v] < e[j]:
            l += min(e[j], de[v]) - max(s[j], ds[v])
            v += 1
        keep[j] = l <= span[j] >> 1
    return x[keep], y[keep]


@dataclass
class SeedHits:
    ax: np.ndarray  # anchor.x  = strand<<63 | rid<<32 | rpos
    ay: np.ndarray  # anchor.y  = flags | span<<32 | qpos
    rep_len: int
    mini_pos: np.ndarray  # uint64: span<<32 | qpos (for mm_est_err)


def collect_seed_hits(opt, max_occ, mi, qname, mv_x, mv_y, qlen) -> SeedHits:
    """Index lookups + anchor construction (reference collect_matches +
    collect_seed_hits, map.c:97-130,222-254).

    High-occurrence minimizers (>= max_occ) are excluded and their query
    footprint merged into rep_len; remaining hits become anchors sorted by
    reference position (stable, preserving per-minimizer occurrence order).
    """
    n = len(mv_x)
    if n == 0:
        return SeedHits(
            np.zeros(0, np.uint64), np.zeros(0, np.uint64), 0, np.zeros(0, np.uint64)
        )
    keys = mv_x >> np.uint64(8)
    spans = (mv_x & np.uint64(0xFF)).astype(np.int64)
    q_pos = (mv_y & np.uint64(0xFFFFFFFF)).astype(np.int64)  # pos<<1|strand
    seg_id = (mv_y >> np.uint64(32)).astype(np.int64)
    found, rs, rc = mi.get_batch(keys)
    rc = np.where(found, rc, 0)

    # rep_len: merged intervals of over-threshold minimizer footprints
    # (reference collect_matches, map.c:105-127)
    over = rc >= max_occ
    rep_len = 0
    rep_st = rep_en = 0
    for i in np.nonzero(over)[0]:
        en = (q_pos[i] >> 1) + 1
        st = en - spans[i]
        if st > rep_en:
            rep_len += rep_en - rep_st
            rep_st, rep_en = st, en
        else:
            rep_en = en
    rep_len += rep_en - rep_st

    keep = found & ~over
    is_tandem = np.zeros(n, dtype=bool)
    if n > 1:
        same_prev = keys[1:] == keys[:-1]
        is_tandem[1:] |= same_prev
        is_tandem[:-1] |= same_prev
    kidx = np.nonzero(keep)[0]
    mini_pos = (
        (spans[kidx].astype(np.uint64) << np.uint64(32))
        | (q_pos[kidx] >> 1).astype(np.uint64)
    )

    total = int(rc[kidx].sum())
    flag = opt.flag
    check_skip = bool(flag & (MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_FOR_ONLY | MM_F_REV_ONLY))
    if not check_skip and total:
        # fully vectorized anchor construction (reference
        # collect_seed_hits inner loop, map.c:232-252, fast path)
        reps = rc[kidx].astype(np.int64)
        starts = rs[kidx].astype(np.int64)
        occ_idx = np.repeat(starts, reps) + (
            np.arange(int(reps.sum()))
            - np.repeat(np.cumsum(reps) - reps, reps))
        rv = mi.pos[occ_idx]
        src = np.repeat(kidx, reps)
        qp_v = q_pos[src].astype(np.uint64)
        span_v = spans[src].astype(np.uint64)
        sid_v = seg_id[src].astype(np.uint64)
        tan_v = is_tandem[src]
        fwd = ((rv & np.uint64(1)) == (qp_v & np.uint64(1)))
        rpos = (rv & np.uint64(0xFFFFFFFF)) >> np.uint64(1)
        rhi = rv & np.uint64(0xFFFFFFFF00000000)
        x = np.where(fwd, rhi | rpos,
                     np.uint64(1) << np.uint64(63) | rhi | rpos)
        qpos_half = qp_v >> np.uint64(1)
        y_fwd = (span_v << np.uint64(32)) | qpos_half
        qlen_u = np.uint64(qlen)
        y_rev = (span_v << np.uint64(32)) | (
            qlen_u - (qpos_half + np.uint64(1) - span_v) - np.uint64(1))
        y = np.where(fwd, y_fwd, y_rev)
        y |= sid_v << np.uint64(MM_SEED_SEG_SHIFT)
        y = np.where(tan_v, y | np.uint64(MM_SEED_TANDEM), y)
        order = _anchor_order(x)
        return SeedHits(x[order], y[order], int(rep_len), mini_pos)

    ax = np.empty(total, dtype=np.uint64)
    ay = np.empty(total, dtype=np.uint64)
    w = 0
    name2rid = mi.name_to_rid() if (qname and (flag & (MM_F_NO_DIAG | MM_F_NO_DUAL))) else None
    for i in kidx:
        occ = mi.pos[rs[i] : rs[i] + rc[i]]
        qp = q_pos[i]
        span = spans[i]
        sid = seg_id[i]
        for r in occ.tolist():
            is_self = False
            if check_skip:
                skip = False
                if qname and (flag & (MM_F_NO_DIAG | MM_F_NO_DUAL)):
                    rid_t = r >> 32
                    sname = mi.seqs[rid_t].name
                    cmp = (qname > sname) - (qname < sname)
                    if (flag & MM_F_NO_DIAG) and cmp == 0 and mi.seqs[rid_t].length == qlen:
                        if (r & 0xFFFFFFFF) >> 1 == qp >> 1:
                            skip = True
                        elif (r & 1) == (qp & 1):
                            is_self = True
                    if (flag & MM_F_NO_DUAL) and cmp > 0:
                        skip = True
                if flag & (MM_F_FOR_ONLY | MM_F_REV_ONLY):
                    if (r & 1) == (qp & 1):
                        if flag & MM_F_REV_ONLY:
                            skip = True
                    else:
                        if flag & MM_F_FOR_ONLY:
                            skip = True
                if skip:
                    continue
            rpos = (r & 0xFFFFFFFF) >> 1
            if (r & 1) == (qp & 1):  # forward strand
                x = (r & 0xFFFFFFFF00000000) | rpos
                y = span << 32 | (qp >> 1)
            else:  # reverse strand
                x = 1 << 63 | (r & 0xFFFFFFFF00000000) | rpos
                y = span << 32 | (qlen - ((qp >> 1) + 1 - span) - 1)
            y |= sid << MM_SEED_SEG_SHIFT
            if is_tandem[i]:
                y |= MM_SEED_TANDEM
            if is_self:
                y |= MM_SEED_SELF
            ax[w] = x
            ay[w] = y
            w += 1
    ax = ax[:w]
    ay = ay[:w]
    order = _anchor_order(ax)
    return SeedHits(ax[order], ay[order], int(rep_len), mini_pos)


def _anchor_order(x: np.ndarray) -> np.ndarray:
    """Anchor sort permutation: stable by x (reference radix_sort_128x),
    except in the seed and polish dump modes, which take the reference's
    unstable in-place radix order (utils/dbg.ref_radix_argsort) so that the
    SD/CN lines are byte-equal; equal-x order never changes the mapping
    output on the goldens (tests/test_torch_dbg.py)."""
    if dbg.flag & (dbg.DBG_PRINT_SEED | dbg.DBG_POLISH):
        return dbg.ref_radix_argsort(x)
    return np.argsort(x, kind="stable")
