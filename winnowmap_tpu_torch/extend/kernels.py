"""Extension DP on the device: the extd wavefront (K1) and the traceback (K2).

Counterpart of winnowmap_tpu/extend/pallas_kernel.py for PyTorch and CUDA.
Semantics are those of the reference ksw_extd2_sse + ksw_backtrack
(src/ksw2_extd2_sse.c, src/ksw2.h:119-151) as the native oracle encodes them
(native/src/wm_ksw.cpp wm_extd): wrapping int8 difference-form state, the
16-lane band rounding, the SSE row-max tie order, z-drop, approx-max /
approx-drop and mqe/mte.  Results and CIGARs equal native.extd exactly.

Each kernel has
  * a wrapper (extd_dp, traceback) that launches the CUDA kernel for CUDA
    tensors and counts the launch in LAUNCHES, and uses the plain version
    only for tensors on the CPU;
  * a plain PyTorch version (extd_dp_plain, traceback_plain) that runs the
    same recurrence vectorised over jobs and band lanes, on any device.

DevCallPooled strings the pieces together for one batch of engine jobs:
descriptors up, K1, start selection, K2, 2-bit op packing, one
device-to-host copy; collect_blob() decodes it into the engine's deliver
layout.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NEG_INF = -0x40000000

EZ_SCORE_ONLY = 0x01
EZ_RIGHT = 0x02
EZ_GENERIC_SC = 0x04
EZ_APPROX_MAX = 0x08
EZ_APPROX_DROP = 0x10
EZ_EXTZ_ONLY = 0x40
EZ_REV_CIGAR = 0x80
EZ_SPLICE = 0x100 | 0x200 | 0x400

# kernel launches on this process, by kernel; chip_smoke.py zeroes them
# around the main path to show it went through the kernels
LAUNCHES = {"extd": 0, "traceback": 0}

def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _c_div(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


@dataclass(frozen=True)
class ExtdProfile:
    """Per-call scoring of the extd kernel, after the gap-pair swap
    (q + e <= q2 + e2, as wm_extd canonicalises)."""

    q: int
    e: int
    q2: int
    e2: int
    sc_mch: int
    sc_mis: int
    sc_n: int
    long_thres: int
    long_diff: int
    # wm_extd returns an empty result when -min(mat) > 2 * (q + e)
    dead: bool


def extd_profile(mat, q, e, q2, e2) -> ExtdProfile:
    mat = np.asarray(mat, np.int8)
    if q2 + e2 < q + e:
        q, q2 = q2, q
        e, e2 = e2, e
    sc_n = int(mat[24]) if mat[24] != 0 else -e2
    long_thres = _c_div(q2 - q, e - e2) - 1 if e != e2 else 0
    if q2 + e2 + long_thres * e2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * (e - e2) - (q2 - q) - e2
    return ExtdProfile(q, e, q2, e2, int(mat[0]), int(mat[1]), sc_n,
                       long_thres, long_diff,
                       -int(mat.min()) > 2 * (q + e))


@dataclass
class JobGeometry:
    """Host-side per-job layout of one call: the effective band w, the
    direction buffer (rows of ncol bytes, nbytes per job at dirs_off), and
    the ring capacity K1 needs for the band state."""

    w_eff: np.ndarray  # (B,) int64
    ncol: np.ndarray  # (B,) int64, wm_extd's n_col
    rows: np.ndarray  # (B,) int64, qlen + tlen - 1
    nbytes: np.ndarray  # (B,) int64, rows * ncol
    dirs_off: np.ndarray  # (B,) int64
    dirs_bytes: int
    cap: int  # power of two >= widest band + 64


def job_geometry(ja: np.ndarray) -> JobGeometry:
    ql = ja[:, 1].astype(np.int64)
    tl = ja[:, 4].astype(np.int64)
    w = ja[:, 6].astype(np.int64)
    w_eff = np.where(w < 0, np.maximum(ql, tl), w)
    band = np.minimum(np.minimum(ql, tl), w_eff + 1)
    ncol = ((band + 15) // 16 + 1) * 16
    rows = np.maximum(ql + tl - 1, 0)
    nbytes = rows * ncol
    band_max = int(max(1, band.max())) if len(band) else 1
    cap = 64
    while cap < band_max + 64:
        cap *= 2
    return JobGeometry(w_eff, ncol, rows, nbytes, np.cumsum(nbytes) - nbytes,
                       int(nbytes.sum()), cap)


# --------------------------------------------------------------------------
# K1: extd wavefront
# --------------------------------------------------------------------------

def _w8(a):
    """Wrap an integer (tensor or int) into int8 range (two's complement)."""
    return ((a + 128) & 255) - 128


def _ubound(r: int, p: ExtdProfile) -> int:
    # u[r]/v1 boundary value at t == r (reference ksw2_extd2_sse.c:150-155)
    if r == 0:
        return -(p.q + p.e)
    if r < p.long_thres:
        return -p.e
    if r == p.long_thres:
        return _w8(p.long_diff)
    return -p.e2


def _apply_zdrop(st, rows, H, t, r, zd, e2):
    """Vectorised wm_ksw apply_zdrop (reference ksw2.h:160-176) on the job
    subset `rows`; returns the dropped mask over that subset."""
    mx, max_t, max_q = st["mx"][rows], st["max_t"][rows], st["max_q"][rows]
    gt = H > mx
    cond = (~gt) & (t >= max_t) & (r - t >= max_q)
    tl_ = t - max_t
    ql_ = (r - t) - max_q
    drop = cond & (zd >= 0) & (mx - H > zd + (tl_ - ql_).abs() * e2)
    st["mx"][rows] = torch.where(gt, H, mx)
    st["max_t"][rows] = torch.where(gt, t, max_t)
    st["max_q"][rows] = torch.where(gt, r - t, max_q)
    return drop


def extd_dp_plain(qpool, tpool, jobs, dirs_off, ncol, prof: ExtdProfile,
                  flag: int, res, dirs) -> None:
    """Plain PyTorch K1 on the device of its inputs.  jobs: (B, 8) int64
    [qoff qlen qrev toff tlen trev w zdrop] with w already effective;
    dirs_off/ncol: (B,) int64.  Fills res (B, 16) int32 and, with a CIGAR,
    the banded direction bytes of every computed row in dirs.  It keeps
    the band state by absolute lane, so it needs no ring capacity."""
    dev = jobs.device
    i64 = torch.int64
    B = jobs.shape[0]
    res.zero_()
    qo, ql, qrev = jobs[:, 0], jobs[:, 1], jobs[:, 2] != 0
    to, tl, trev = jobs[:, 3], jobs[:, 4], jobs[:, 5] != 0
    w, zd = jobs[:, 6], jobs[:, 7]
    q, e, q2, e2 = prof.q, prof.e, prof.q2, prof.e2
    qe, qe2 = q + e, q2 + e2
    with_cigar = not (flag & EZ_SCORE_ONLY)
    approx_max = bool(flag & EZ_APPROX_MAX)
    approx_drop = bool(flag & EZ_APPROX_DROP)
    right = bool(flag & EZ_RIGHT)

    st = {
        "mx": torch.zeros(B, dtype=i64, device=dev),
        "max_q": torch.full((B,), -1, dtype=i64, device=dev),
        "max_t": torch.full((B,), -1, dtype=i64, device=dev),
        "mqe": torch.full((B,), NEG_INF, dtype=i64, device=dev),
        "mqe_t": torch.full((B,), -1, dtype=i64, device=dev),
        "mte": torch.full((B,), NEG_INF, dtype=i64, device=dev),
        "mte_q": torch.full((B,), -1, dtype=i64, device=dev),
        "score": torch.full((B,), NEG_INF, dtype=i64, device=dev),
        "zdr": torch.zeros(B, dtype=i64, device=dev),
    }
    alive = (ql > 0) & (tl > 0)
    if prof.dead:
        alive[:] = False
    if B == 0 or not bool(alive.any()):
        _store_res(res, st)
        return
    LQ = int(ql.max())
    LT = int(tl.max())
    # reversed query qr[t] = query[qlen-1-t] and target, 0-padded
    cq = torch.arange(LQ, device=dev)[None, :]
    qix = torch.where(qrev[:, None], qo[:, None] + cq,
                      qo[:, None] + ql[:, None] - 1 - cq)
    qmask = cq < ql[:, None]
    qr = torch.where(qmask, qpool[qix.clamp(0, qpool.numel() - 1)].long(), 0)
    ct = torch.arange(LT, device=dev)[None, :]
    tix = torch.where(trev[:, None], to[:, None] + tl[:, None] - 1 - ct,
                      to[:, None] + ct)
    tmask = ct < tl[:, None]
    tg = torch.where(tmask, tpool[tix.clamp(0, tpool.numel() - 1)].long(), 0)

    W = int(ncol.max()) + 17  # window: lanes st-1 .. st+W-2
    T = (LT + 15) // 16 * 16 + 32 + W + 2  # column = lane + 1
    init1, init2 = _w8(-qe), _w8(-qe2)
    U = torch.full((B, T), init1, dtype=i64, device=dev)
    V = U.clone()
    X = U.clone()
    Y = U.clone()
    X2 = torch.full((B, T), init2, dtype=i64, device=dev)
    Y2 = X2.clone()
    S = torch.zeros((B, T), dtype=i64, device=dev)
    Hs = None if approx_max else torch.full((B, T), NEG_INF, dtype=i64,
                                             device=dev)
    H0 = torch.zeros(B, dtype=i64, device=dev)
    lastH = torch.zeros(B, dtype=i64, device=dev)
    last_st = torch.full((B,), -1, dtype=i64, device=dev)
    last_en = torch.full((B,), -1, dtype=i64, device=dev)
    R = ql + tl - 1
    kk = torch.arange(W, device=dev)[None, :]
    lo = slice(1, W)

    for r in range(int(R.max())):
        act = alive & (r < R)
        if not bool(act.any()):
            break
        rows = act.nonzero().squeeze(1)
        qlr, tlr, wr = ql[rows], tl[rows], w[rows]
        st0 = torch.maximum(torch.maximum(torch.zeros_like(qlr), r - qlr + 1),
                            torch.div(r - wr + 1, 2, rounding_mode="floor"))
        en0 = torch.minimum(torch.minimum(tlr - 1, torch.full_like(tlr, r)),
                            torch.div(r + wr, 2, rounding_mode="floor"))
        bad = st0 > en0
        if bool(bad.any()):
            st["zdr"][rows[bad]] = 1
            alive[rows[bad]] = False
            keep = ~bad
            rows, qlr, tlr = rows[keep], qlr[keep], tlr[keep]
            st0, en0 = st0[keep], en0[keep]
            if rows.numel() == 0:
                continue
        n = rows.numel()
        stb = torch.div(st0, 16, rounding_mode="floor") * 16
        enb = torch.div(en0 + 16, 16, rounding_mode="floor") * 16 - 1
        lanes = stb[:, None] - 1 + kk  # (n, W)
        cols = lanes + 1
        ri = rows[:, None]
        u_o, v_o, x_o = U[ri, cols], V[ri, cols], X[ri, cols]
        y_o, x2_o, y2_o = Y[ri, cols], X2[ri, cols], Y2[ri, cols]
        s_o = S[ri, cols]
        t = lanes[:, lo]
        # boundary carry into lane st (reference ksw2_extd2_sse.c:150-160)
        ub = _ubound(r, prof)
        carry = ((stb > 0) & (stb - 1 >= last_st[rows])
                 & (stb - 1 <= last_en[rows]))
        x1 = torch.where(carry, x_o[:, 0], init1)
        x21 = torch.where(carry, x2_o[:, 0], init2)
        v1 = torch.where(carry, v_o[:, 0],
                         torch.where(stb > 0, init1, ub))
        xt1 = torch.cat([x1[:, None], x_o[:, 1:W - 1]], 1)
        x2t1 = torch.cat([x21[:, None], x2_o[:, 1:W - 1]], 1)
        vt1 = torch.cat([v1[:, None], v_o[:, 1:W - 1]], 1)
        atr = t == r
        ut = torch.where(atr, ub, u_o[:, lo])
        yt = torch.where(atr, init1, y_o[:, lo])
        y2t = torch.where(atr, init2, y2_o[:, lo])
        # scores: lanes [st0, g+15] are rewritten (16-lane stores from st0)
        g = st0 + torch.div(en0 - st0, 16, rounding_mode="floor") * 16
        in_s = (t >= st0[:, None]) & (t <= g[:, None] + 15)
        a_c = torch.where(t < tlr[:, None],
                          tg[ri, t.clamp(0, LT - 1)], 0)
        qidx = qlr[:, None] - 1 - r + t
        b_c = torch.where((qidx >= 0) & (qidx < qlr[:, None]),
                          qr[ri, qidx.clamp(0, LQ - 1)], 0)
        sc = torch.where((a_c == 4) | (b_c == 4), prof.sc_n,
                         torch.where(a_c == b_c, prof.sc_mch, prof.sc_mis))
        z = torch.where(in_s, sc, s_o[:, lo])
        s_new = z
        # the cell (wm_extd inner loop)
        a = _w8(xt1 + vt1)
        b = _w8(yt + ut)
        a2 = _w8(x2t1 + vt1)
        b2 = _w8(y2t + ut)
        if not right:
            d = (a > z).long()
            z = torch.maximum(z, a)
            d = torch.where(b > z, 2, d)
            z = torch.maximum(z, b)
            d = torch.where(a2 > z, 3, d)
            z = torch.maximum(z, a2)
            d = torch.where(b2 > z, 4, d)
            z = torch.maximum(z, b2)
        else:
            d = torch.where(z > a, 0, 1)
            z = torch.maximum(z, a)
            d = torch.where(z > b, d, 2)
            z = torch.maximum(z, b)
            d = torch.where(z > a2, d, 3)
            z = torch.maximum(z, a2)
            d = torch.where(z > b2, d, 4)
            z = torch.maximum(z, b2)
        z = torch.clamp(z, max=prof.sc_mch)
        u_n = _w8(z - vt1)
        v_n = _w8(z - ut)
        zq = _w8(z - q)
        zq2 = _w8(z - q2)
        an, bn = _w8(a - zq), _w8(b - zq)
        a2n, b2n = _w8(a2 - zq2), _w8(b2 - zq2)
        if not right:
            ax, bx, a2x, b2x = an > 0, bn > 0, a2n > 0, b2n > 0
        else:
            ax, bx, a2x, b2x = an >= 0, bn >= 0, a2n >= 0, b2n >= 0
        x_n = _w8(torch.where(ax, an, 0) - qe)
        y_n = _w8(torch.where(bx, bn, 0) - qe)
        x2_n = _w8(torch.where(a2x, a2n, 0) - qe2)
        y2_n = _w8(torch.where(b2x, b2n, 0) - qe2)
        d = (d | (ax.long() << 3) | (bx.long() << 4) | (a2x.long() << 5)
             | (b2x.long() << 6))
        band = t <= enb[:, None]
        cl = cols[:, lo]
        u_w = torch.where(band, u_n, u_o[:, lo])
        v_w = torch.where(band, v_n, v_o[:, lo])
        U[ri, cl] = u_w
        V[ri, cl] = v_w
        X[ri, cl] = torch.where(band, x_n, x_o[:, lo])
        Y[ri, cl] = torch.where(band, y_n, y_o[:, lo])
        X2[ri, cl] = torch.where(band, x2_n, x2_o[:, lo])
        Y2[ri, cl] = torch.where(band, y2_n, y2_o[:, lo])
        S[ri, cl] = torch.where(in_s, s_new, s_o[:, lo])
        if with_cigar:
            pos = (dirs_off[rows][:, None] + r * ncol[rows][:, None]
                   + (t - stb[:, None]))
            dirs[pos[band]] = d[band].to(torch.uint8)
        # new u/v over the full window (position 0 = lane st-1, unchanged)
        u_f = torch.cat([u_o[:, :1], u_w], 1)
        v_f = torch.cat([v_o[:, :1], v_w], 1)

        def at(win, lane):  # window value at an absolute lane per row
            p = (lane - stb + 1).clamp(0, W - 1)
            return win.gather(1, p[:, None]).squeeze(1)

        zd_r = zd[rows]
        if not approx_max:
            Hw = Hs[ri, cols]
            if r == 0:
                Hn = at(v_f, en0) - qe
                Hw = Hw.scatter(1, torch.ones_like(en0)[:, None], Hn[:, None])
                max_H, max_t = Hn, torch.zeros_like(en0)
            else:
                Hen = torch.where(en0 > 0, at(Hw, en0 - 1) + at(u_f, en0),
                                  at(Hw, en0) + at(v_f, en0))
                tf = lanes
                inb = (tf >= st0[:, None]) & (tf < en0[:, None])
                Hw = torch.where(inb, Hw + v_f,
                                 torch.where(tf == en0[:, None], Hen[:, None],
                                             Hw))
                # SSE tie order: en0 first, then 4-lane strides, then tail
                en1 = st0 + torch.div(en0 - st0, 4, rounding_mode="floor") * 4
                nk = torch.div(en1 - st0, 4, rounding_mode="floor")
                rel = tf - st0[:, None]
                rank = torch.where(
                    tf == en0[:, None], 0,
                    torch.where(tf < en1[:, None],
                                1 + (rel & 3) * nk[:, None] + (rel >> 2),
                                1 + 4 * nk[:, None] + (tf - en1[:, None])))
                live = (tf >= st0[:, None]) & (tf <= en0[:, None])
                key = torch.where(live, Hw * (1 << 32) + (0xFFFFFFFF - rank),
                                  torch.iinfo(torch.int64).min)
                kmax, kpos = key.max(1)
                max_H = torch.div(kmax, 1 << 32, rounding_mode="floor")
                max_t = lanes.gather(1, kpos[:, None]).squeeze(1)
            Hs[ri, cols] = Hw
            h_en, h_st = at(Hw, en0), at(Hw, st0)
            upd = (en0 == tlr - 1) & (h_en > st["mte"][rows])
            st["mte"][rows] = torch.where(upd, h_en, st["mte"][rows])
            st["mte_q"][rows] = torch.where(upd, r - enb, st["mte_q"][rows])
            upd = (r - st0 == qlr - 1) & (h_st > st["mqe"][rows])
            st["mqe"][rows] = torch.where(upd, h_st, st["mqe"][rows])
            st["mqe_t"][rows] = torch.where(upd, st0, st["mqe_t"][rows])
            drop = _apply_zdrop(st, rows, max_H, max_t, r, zd_r, e2)
            fin = (~drop) & (r == qlr + tlr - 2) & (en0 == tlr - 1)
            st["score"][rows] = torch.where(fin, h_en, st["score"][rows])
        else:
            if r == 0:
                H0[rows] = at(v_f, torch.zeros_like(en0)) - qe
                lastH[rows] = 0
                drop = torch.zeros_like(en0, dtype=torch.bool)
            else:
                lt = lastH[rows]
                in1 = (lt >= st0) & (lt <= en0)
                in2 = (lt + 1 >= st0) & (lt + 1 <= en0)
                d0 = at(v_f, lt)
                d1 = at(u_f, lt + 1)
                both = in1 & in2
                h0 = H0[rows] + torch.where(
                    both, torch.maximum(d0, d1), torch.where(in1, d0, d1))
                lt = lt + torch.where(both, (d0 <= d1).long(),
                                      torch.where(in1, 0, 1))
                H0[rows] = h0
                lastH[rows] = lt
                if approx_drop:
                    drop = _apply_zdrop(st, rows, h0, lt, r, zd_r, e2)
                else:
                    drop = torch.zeros_like(en0, dtype=torch.bool)
            fin = (~drop) & (r == qlr + tlr - 2) & (en0 == tlr - 1)
            st["score"][rows] = torch.where(fin, H0[rows], st["score"][rows])
        if bool(drop.any()):
            st["zdr"][rows[drop]] = 1
            alive[rows[drop]] = False
        last_st[rows] = stb
        last_en[rows] = enb
    _store_res(res, st)


def _store_res(res, st) -> None:
    cols = [st[k] for k in ("mx", "zdr", "max_q", "max_t", "mqe", "mqe_t",
                            "mte", "mte_q", "score")]
    res[:, :9] = torch.stack(cols, 1).to(torch.int32)


def _check_kernel_args(*tensors) -> None:
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("kernel arguments must be contiguous CUDA "
                             "tensors")


def extd_dp(qpool, tpool, jobs, dirs_off, ncol, cap, prof: ExtdProfile,
            flag: int, dirs_bytes: int):
    """K1.  Returns (res (B, 16) int32, dirs (dirs_bytes,) uint8) on the
    device of `jobs`.  CUDA tensors launch csrc/extd.cu; CPU tensors run
    extd_dp_plain."""
    dev = jobs.device
    B = jobs.shape[0]
    res = torch.empty((B, 16), dtype=torch.int32, device=dev)
    with_cigar = not (flag & EZ_SCORE_ONLY)
    dirs = torch.empty(max(1, dirs_bytes if with_cigar else 1),
                       dtype=torch.uint8, device=dev)
    if dev.type == "cpu":
        extd_dp_plain(qpool, tpool, jobs, dirs_off, ncol, prof, flag, res,
                      dirs)
        return res, dirs
    if jobs.dtype != torch.int64 or jobs.shape[1:] != (8,):
        raise ValueError("jobs must be (B, 8) int64")
    _check_kernel_args(qpool, tpool, jobs, dirs_off)
    from . import _build

    res.zero_()
    lib = _build.load()
    exact = not (flag & EZ_APPROX_MAX)
    ring = cap * (7 + (4 if exact else 0))
    use_smem = ring <= _build.EXTD_SMEM_MAX
    scratch = (torch.empty(1, dtype=torch.uint8, device=dev) if use_smem
               else torch.empty(B * ring, dtype=torch.uint8, device=dev))
    threads = 128 if cap <= 2048 else 256
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.wm_extd_launch(
        qpool.data_ptr(), tpool.data_ptr(), jobs.data_ptr(), B,
        dirs_off.data_ptr(), dirs.data_ptr(), res.data_ptr(),
        scratch.data_ptr(), cap, int(use_smem), threads,
        prof.q, prof.e, prof.q2, prof.e2, prof.sc_mch, prof.sc_mis,
        prof.sc_n, prof.long_thres, prof.long_diff, int(prof.dead), flag,
        stream)
    if rc != 0:
        raise RuntimeError(f"extd kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    LAUNCHES["extd"] += 1
    return res, dirs


# --------------------------------------------------------------------------
# start selection (plain torch on the device)
# --------------------------------------------------------------------------

def select_starts(res, jobs, end_bonus, extz_only: bool, dead: bool):
    """Traceback start (i0, j0) per job, (B, 2) int32 (reference wm_ksw.cpp
    wm_extd tail): full reach unless z-dropped; with EXTZ_ONLY, the query
    end when mqe + end_bonus > max; else the running max; -1 = no CIGAR."""
    mx, zdr = res[:, 0].long(), res[:, 1] != 0
    max_q, max_t = res[:, 2].long(), res[:, 3].long()
    mqe, mqe_t = res[:, 4].long(), res[:, 5].long()
    ql, tl = jobs[:, 1], jobs[:, 4]
    ok_max = (max_t >= 0) & (max_q >= 0)
    neg = torch.full_like(ql, -1)
    if not extz_only:
        i0 = torch.where(~zdr, tl - 1, torch.where(ok_max, max_t, neg))
        j0 = torch.where(~zdr, ql - 1, torch.where(ok_max, max_q, neg))
    else:
        reach = (~zdr) & (mqe + end_bonus > mx)
        i0 = torch.where(reach, mqe_t, torch.where(ok_max, max_t, neg))
        j0 = torch.where(reach, ql - 1, torch.where(ok_max, max_q, neg))
    empty = (ql <= 0) | (tl <= 0)
    if dead:
        empty = torch.ones_like(empty)
    i0 = torch.where(empty, neg, i0)
    j0 = torch.where(empty, neg, j0)
    return torch.stack([i0, j0], 1).to(torch.int32).contiguous()


# --------------------------------------------------------------------------
# K2: traceback
# --------------------------------------------------------------------------

def traceback_plain(dirs, dirs_off, jobs, ncol, start, ops, fin) -> None:
    """Plain PyTorch K2: every job walks its direction rows from (i0, j0)
    over descending anti-diagonals (reference ksw_backtrack, is_rot=1,
    min_intron_len=0, force-state band clamp).  Writes the op byte
    (0 M, 1 I, 2 D) at ops[b, r] for each visited diagonal r (the rest stay
    255) and the remaining (i, j) into fin (B, 2) int32."""
    ops.fill_(255)
    i = start[:, 0].long().clone()
    j = start[:, 1].long().clone()
    state = torch.zeros_like(i)
    ql, tl, w = jobs[:, 1], jobs[:, 4], jobs[:, 6]
    nd = dirs.numel()
    while True:
        act = (i >= 0) & (j >= 0)
        if not bool(act.any()):
            break
        rows = act.nonzero().squeeze(1)
        ii, jj, s = i[rows], j[rows], state[rows]
        r = ii + jj
        qlr, tlr, wr = ql[rows], tl[rows], w[rows]
        st0 = torch.maximum(torch.maximum(torch.zeros_like(r), r - qlr + 1),
                            torch.div(r - wr + 1, 2, rounding_mode="floor"))
        en0 = torch.minimum(torch.minimum(tlr - 1, r),
                            torch.div(r + wr, 2, rounding_mode="floor"))
        stb = torch.div(st0, 16, rounding_mode="floor") * 16
        enb = torch.div(en0 + 16, 16, rounding_mode="floor") * 16 - 1
        force2 = ii < stb
        force1 = ii > enb
        pos = dirs_off[rows] + r * ncol[rows] + ii - stb
        d = dirs[pos.clamp(0, nd - 1)].long()
        d = torch.where(force1 | force2, 0, d)
        keep = ((d >> (s + 2).clamp(max=62)) & 1) != 0
        s1 = torch.where(s == 0, d & 7, torch.where(keep, s, 0))
        s2 = torch.where(s1 == 0, d & 7, s1)
        s3 = torch.where(force2, 2, torch.where(force1, 1, s2))
        op = torch.where(s3 == 0, 0, torch.where((s3 == 1) | (s3 == 3), 2, 1))
        ops[rows, r] = op.to(torch.uint8)
        i[rows] = ii - (op != 1).long()
        j[rows] = jj - (op != 2).long()
        state[rows] = s3
    fin[:, 0] = i.to(torch.int32)
    fin[:, 1] = j.to(torch.int32)


def traceback(dirs, dirs_off, jobs, ncol, start, n_ops: int):
    """K2.  Returns (ops (B, n_ops) uint8, fin (B, 2) int32); n_ops is a
    multiple of 4 covering every job's diagonals."""
    dev = dirs.device
    B = jobs.shape[0]
    ops = torch.empty((B, n_ops), dtype=torch.uint8, device=dev)
    fin = torch.empty((B, 2), dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        traceback_plain(dirs, dirs_off, jobs, ncol, start, ops, fin)
        return ops, fin
    _check_kernel_args(dirs, dirs_off, jobs, start)
    from . import _build

    ops.fill_(255)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.wm_traceback_launch(
        dirs.data_ptr(), dirs_off.data_ptr(), jobs.data_ptr(),
        start.data_ptr(), B, ops.data_ptr(), n_ops, fin.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"traceback kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    LAUNCHES["traceback"] += 1
    return ops, fin


def pack_ops(ops):
    """Pack op bytes 4 per byte, 2 bits each (idle 255 -> 3), the layout
    native.rle_ops_blob decodes."""
    B, n = ops.shape
    o = torch.clamp(ops, max=3).view(B, n // 4, 4)
    return (o[..., 0] | (o[..., 1] << 2) | (o[..., 2] << 4)
            | (o[..., 3] << 6)).contiguous()


# --------------------------------------------------------------------------
# pooled calls
# --------------------------------------------------------------------------

class PoolContext:
    """The sequence pools of one mapping batch on the device: the batch's
    read-strand pool and the reference codes.  The reference upload is kept
    on the index object (one per device) so later batches reuse it."""

    def __init__(self, qpool_np: np.ndarray, mi, device: torch.device):
        self.device = torch.device(device)
        self.qpool = torch.from_numpy(qpool_np).to(self.device)
        cache = mi.device_codes
        key = str(self.device)
        if key not in cache:
            cache.clear()  # one device copy of the reference at a time
            cache[key] = torch.from_numpy(
                np.ascontiguousarray(mi.codes, np.uint8)).to(self.device)
        self.ref = cache[key]


class DevCallPooled:
    """One pooled batch of extd jobs on the device.

    jobs: (B0, 8) int array of (qoff, qlen, qrev, toff, tlen, trev, w, zdrop)
    rows (the engine's flat job columns; qoff indexes the read pool, toff the
    reference).  mat/q/e/q2/e2 the scoring, end_bonus a scalar or per-job
    array, flag the ksw flags.  Launches everything asynchronously;
    collect_blob() waits and decodes."""

    def __init__(self, pools: PoolContext, jobs, mat, q, e, q2, e2,
                 end_bonus, flag):
        flag = int(flag)
        if flag & EZ_SPLICE:
            raise NotImplementedError(
                "spliced extension (exts kernel) is not ported yet")
        if q == q2 and e == e2:
            raise NotImplementedError(
                "single-cost profiles (q == q2 and e == e2) need the extz "
                "kernel, which is not ported yet")
        if flag & EZ_GENERIC_SC:
            raise NotImplementedError("generic scoring matrices are not "
                                      "supported by the extd kernel")
        ja = np.ascontiguousarray(jobs, np.int64).reshape(-1, 8).copy()
        B0 = len(ja)
        self.B0 = B0
        self.with_cigar = not (flag & EZ_SCORE_ONLY)
        self.extz_only = bool(flag & EZ_EXTZ_ONLY)
        self.rev_cigar = bool(flag & EZ_REV_CIGAR)
        self.end_bonus = np.broadcast_to(
            np.asarray(end_bonus, np.int64), (B0,)).copy()
        prof = extd_profile(mat, q, e, q2, e2)
        geo = job_geometry(ja)
        ja[:, 6] = geo.w_eff
        self.geometry = geo
        dev = pools.device
        self.device = dev
        jobs_t = torch.from_numpy(ja).to(dev)
        off_t = torch.from_numpy(geo.dirs_off).to(dev)
        ncol_t = torch.from_numpy(geo.ncol).to(dev)
        res, dirs = extd_dp(pools.qpool, pools.ref, jobs_t, off_t, ncol_t,
                            geo.cap, prof, flag, geo.dirs_bytes)
        if self.with_cigar:
            eb = torch.from_numpy(self.end_bonus).to(dev)
            start = select_starts(res, jobs_t, eb, self.extz_only, prof.dead)
            n_ops = max(4, (int(geo.rows.max()) + 3) // 4 * 4)
            ops, fin = traceback(dirs, off_t, jobs_t, ncol_t, start, n_ops)
            out = torch.cat([res.view(torch.uint8), fin.view(torch.uint8),
                             pack_ops(ops)], 1)
        else:
            out = res.view(torch.uint8)
        del dirs  # stream-ordered: the allocator reuses it after K2
        if dev.type == "cuda":
            self.host = torch.empty(out.shape, dtype=torch.uint8,
                                    pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))
        else:
            self.host = out
            self.event = None

    def collect_blob(self):
        """Wait for the call and decode it: (res9 (B0, 9) int32 in the
        engine deliver column order, CIGAR blob uint32 | None, per-job blob
        offsets int64, lengths int32, reach_end (B0,) int32)."""
        from .. import native

        if self.event is not None:
            self.event.synchronize()
        buf = self.host.numpy()
        blob = off = ln = None
        if self.with_cigar:
            res = np.ascontiguousarray(buf[:, :64]).view(np.int32)
            fin = np.ascontiguousarray(buf[:, 64:72]).view(np.int32)
            rev = np.full(self.B0, self.rev_cigar, np.uint8)
            blob, off, ln = native.rle_ops_blob(
                np.ascontiguousarray(buf[:, 72:]), fin[:, 0], fin[:, 1], rev)
        else:
            res = np.ascontiguousarray(buf).view(np.int32)
        res9 = np.ascontiguousarray(res[:, :9], np.int32)
        reach = np.zeros(self.B0, np.int32)
        if self.with_cigar and self.extz_only:
            reach = ((res9[:, 1] == 0)
                     & (res9[:, 4] + self.end_bonus > res9[:, 0])
                     ).astype(np.int32)
        return res9, blob, off, ln, reach
