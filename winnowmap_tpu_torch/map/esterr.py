"""Per-region divergence estimate from minimizer retention
(reference src/esterr.c, mm_est_err)."""
from __future__ import annotations

import numpy as np

from .hit import Reg, _i32

U64 = np.uint64


def _get_for_qpos(qlen, axv, ayv):
    x = _i32(ayv)
    q_span = int(ayv >> U64(32) & U64(0xFF))
    if int(axv >> U64(63)):
        x = qlen - 1 - (x + 1 - q_span)
    return x


def est_err(mi, qlen, regs: list[Reg], ax, ay, mini_pos: np.ndarray) -> None:
    n = len(mini_pos)
    if n == 0:
        return
    spans = (mini_pos >> U64(32) & U64(0xFF)).astype(np.int64)
    qpos = (mini_pos & U64(0xFFFFFFFF)).astype(np.int64)
    avg_k = np.float32(spans.sum()) / np.float32(n)
    for r in regs:
        r.div = -1.0
        if r.cnt == 0:
            continue
        a0 = (r.as_ + r.cnt - 1) if r.rev else r.as_
        x = _get_for_qpos(qlen, ax[a0], ay[a0])
        idx = np.searchsorted(qpos, x)
        st = int(idx) if idx < n and qpos[idx] == x else -1
        if st < 0:
            continue
        en = st
        l_ref = mi.seqs[r.rid].length
        k = 1
        n_match = 1
        j = st + 1
        while j < n and k < r.cnt:
            ai = (r.as_ + r.cnt - 1 - k) if r.rev else (r.as_ + k)
            x = _get_for_qpos(qlen, ax[ai], ay[ai])
            if x == qpos[j]:
                k += 1
                en = j
                n_match += 1
            j += 1
        n_tot = en - st + 1
        if r.qs > avg_k and r.rs > avg_k:
            n_tot += 1
        if qlen - r.qs > avg_k and l_ref - r.re > avg_k:
            n_tot += 1
        r.div = (
            0.0
            if n_match >= n_tot
            else float(np.float32(1.0 - pow(n_match / n_tot, 1.0 / float(avg_k))))
        )
