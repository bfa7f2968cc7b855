"""Paired-end / multi-segment fragment logic (reference src/pe.c), as the
JAX package's map/pe.py.

The stock reference binary cannot reach this code: mm_map_frag asserts
n_segs == 1 (reference src/map.c:291-292, a Winnowmap TODO), so paired
input aborts there.  The JAX package implements the fragment path the
reference ships (and minimap2 runs), held byte for byte to an oracle binary
patched only to generalize that assert and to skip the frag-mode read
reshuffle (golden_pe.sam); the port holds it to the JAX package
(tests/test_torch_pe.py) and to that golden.
"""
from __future__ import annotations

import numpy as np

from .hit import Reg, sync_regs

U32 = 0xFFFFFFFF


def select_sub_multi(pri_ratio: float, pri1: float, pri2: float,
                     max_gap_ref: int, min_diff: int, best_n: int,
                     n_segs: int, qlens: list[int],
                     regs: list[Reg]) -> list[Reg]:
    """Multi-segment secondary selection (reference mm_select_sub_multi,
    src/pe.c:6-44)."""
    if pri_ratio <= 0.0 or not regs:
        return regs
    n = len(regs)
    max_dist = qlens[0] + qlens[1] + max_gap_ref if n_segs == 2 else 0
    kept: list[Reg] = []
    n_2nd = 0
    for i, r in enumerate(regs):
        to_keep = False
        if r.parent == i:
            to_keep = True
        elif r.score + min_diff >= regs[r.parent].score:
            to_keep = True
        else:
            p, q = regs[r.parent], r
            if (p.rev == q.rev and p.rid == q.rid
                    and q.re - p.rs < max_dist and p.re - q.rs < max_dist):
                # child and parent are close on the reference
                if q.score >= p.score * np.float32(pri1):
                    to_keep = True
            else:
                is_par_both = (n_segs == 2 and p.qs < qlens[0]
                               and p.qe > qlens[0])
                is_chi_both = (n_segs == 2 and q.qs < qlens[0]
                               and q.qe > qlens[0])
                if is_chi_both or is_chi_both == is_par_both:
                    if q.score >= p.score * np.float32(pri_ratio):
                        to_keep = True
                else:  # is_chi_both == 0 && is_par_both == 1
                    if q.score >= p.score * np.float32(pri2):
                        to_keep = True
        if to_keep and r.parent != i:
            if n_2nd >= best_n:
                to_keep = False
            n_2nd += 1
        if to_keep:
            kept.append(r)
    if len(kept) != n:
        sync_regs(kept)
    return kept


def set_pe_thru(qlens: list[int], regs_pair: list[list[Reg]]) -> None:
    """Detect reads that sequence through the whole fragment (reference
    mm_set_pe_thru, src/pe.c:46-63)."""
    n_pri = [0, 0]
    pri = [-1, -1]
    for s in range(2):
        for i, r in enumerate(regs_pair[s]):
            if r.id == r.parent:
                n_pri[s] += 1
                pri[s] = i
    if n_pri[0] == 1 and n_pri[1] == 1:
        p = regs_pair[0][pri[0]]
        q = regs_pair[1][pri[1]]
        if (p.rid == q.rid and p.rev == q.rev and abs(p.rs - q.rs) < 3
                and abs(p.re - q.re) < 3
                and ((p.qs == 0 and qlens[1] - q.qe == 0)
                     or (q.qs == 0 and qlens[0] - p.qe == 0))):
            p.pe_thru = q.pe_thru = True


def pair(max_gap_ref: int, pe_bonus: int, sub_diff: int, match_sc: int,
         qlens: list[int], regs_pair: list[list[Reg]]) -> None:
    """Best-pair selection + paired MAPQ (reference mm_pair,
    src/pe.c:76-177).  Mutates regs in place (proper_frag, parent lifts,
    sam_pri sync, MAPQ blend)."""
    recs = []  # (s, rev, key, reg)
    dp_thres = 0
    segs = 0
    for s in (0, 1):
        mx = 0
        for r in regs_pair[s]:
            key = (r.rid << 32) | ((r.rs << 1) & U32) | ((s ^ int(r.rev)) & 1)
            recs.append((s, int(r.rev), key, r))
            if r.p is not None:
                mx = max(mx, r.p.dp_max)
            segs |= 1 << s
        dp_thres += mx
    if segs != 3:
        return  # only one end is mapped
    dp_thres = max(0, dp_thres - pe_bonus)
    recs.sort(key=lambda t: t[2])  # radix_sort_pair: stable by key

    best = -1
    best_pair = [None, None]  # per segment
    last = [-1, -1]
    sc: list[int] = []
    for i, (si, revi, keyi, r) in enumerate(recs):
        if keyi & 1:  # reverse first read or forward second read
            if last[revi] < 0:
                continue
            q = recs[last[revi]][3]
            if r.rid != q.rid or r.rs - q.re > max_gap_ref:
                continue
            for j in range(last[revi], -1, -1):
                sj, revj, _, q = recs[j]
                if revj != revi or sj == si:
                    continue
                if r.rid != q.rid or r.rs - q.re > max_gap_ref:
                    break
                if r.p.dp_max + q.p.dp_max < dp_thres:
                    continue
                score = (((r.p.dp_max + q.p.dp_max) << 32)
                         | ((r.hash + q.hash) & U32))
                if score > best:
                    best = score
                    best_pair[sj] = q
                    best_pair[si] = r
                sc.append(score)
        else:  # forward first read or reverse second read
            last[revi] = i
    sc.sort()

    if sc and best > 0:  # found at least one pair
        r2 = best_pair
        r2[0].proper_frag = r2[1].proper_frag = True
        for s in (0, 1):
            rs_ = r2[s]
            regs = regs_pair[s]
            if rs_.id != rs_.parent:  # lift to primary, update parents
                p = regs[rs_.parent]
                for r in regs:
                    if r.parent == p.id:
                        r.parent = rs_.id
                p.mapq = 0
            if not rs_.sam_pri:  # sync sam_pri
                for r in regs:
                    r.sam_pri = False
                rs_.sam_pri = True
        mapq_pe = max(r2[0].mapq, r2[1].mapq)
        n_sub = sum(1 for v in sc if (v >> 32) + sub_diff >= (best >> 32))
        if len(sc) > 1:
            f = np.float32
            # n_sub > 0 because it counts the optimal, too
            alt = int(f(6.02) * f((best >> 32) - (sc[-2] >> 32)) / f(match_sc)
                      - f(4.343) * np.log(f(n_sub)))
            mapq_pe = min(mapq_pe, alt)
        for s in (0, 1):
            if r2[s].mapq < mapq_pe:
                r2[s].mapq = int(np.float32(0.2) * np.float32(r2[s].mapq)
                                 + np.float32(0.8) * np.float32(mapq_pe)
                                 + np.float32(0.499))
        if len(sc) == 1:
            r2[0].mapq = max(r2[0].mapq, 2)
            r2[1].mapq = max(r2[1].mapq, 2)
        elif (best >> 32) > (sc[-2] >> 32):
            r2[0].mapq = max(r2[0].mapq, 1)
            r2[1].mapq = max(r2[1].mapq, 1)

    set_pe_thru(qlens, regs_pair)
