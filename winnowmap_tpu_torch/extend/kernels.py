"""Extension DP on the device: the extd wavefront (K1), the spliced exts
wavefront (K3), the single-cost extz wavefront (K4), the traceback (K2)
and the CIGARs of its walks (R1).

Counterpart of winnowmap_tpu/extend/pallas_kernel.py for PyTorch and CUDA.
Semantics are those of the reference ksw_extd2_sse, ksw_exts2_sse,
ksw_extz2_sse and ksw_backtrack (src/ksw2_extd2_sse.c, src/ksw2_exts2_sse.c,
src/ksw2_extz2_sse.c, src/ksw2.h:119-151) as the native oracle encodes them
(native/src/wm_ksw.cpp wm_extd, wm_exts, wm_extz): wrapping int8
difference-form state (biased unsigned bytes for extz), the 16-lane band
rounding, the SSE row-max tie order, z-drop, approx-max / approx-drop and
mqe/mte; for exts the intron state with its donor/acceptor site scores and
the unbanded anti-diagonal.  Results and CIGARs equal native.extd,
native.exts and native.extz exactly.

Each kernel has
  * a wrapper (extd_dp, exts_dp, extz_dp, traceback, cigar_rle) that
    launches the CUDA kernel for CUDA tensors and counts the launch in
    LAUNCHES, and uses the plain version only for tensors on the CPU;
  * a plain PyTorch version (extd_dp_plain, exts_dp_plain, extz_dp_plain,
    traceback_plain, cigar_rle_plain) that computes the same vectorised
    over jobs (and band lanes), on any device.

DevCallPooled strings the pieces together for one batch of jobs (the
engine's, or the generator path's): descriptors up, K1, K3 or K4, start
selection, K2, R1 (the BAM CIGAR words of every job, in the engine's
deliver layout, on the card), then a device-to-host copy of the results
and each job's CIGAR offset and length.  collect_blob() waits for it and
copies just the call's CIGAR words; collect() gives one native.ExtResult
a job.  Its host-to-device copies before the DP's launch, the end-bonus
copy after it, its wait for the card, the views of the results and the
CIGAR words' copy are the spans dispatch_upload, dispatch_bonus,
collect_sync, collect_decode and collect_copy of the mapping path's STATS
(device.span); collect_runs and collect_d2h_bytes count the words and the
bytes brought back.
"""
from __future__ import annotations

from dataclasses import dataclass

import threading

import numpy as np
import torch

from ..device import STATS, count, span

NEG_INF = -0x40000000

EZ_SCORE_ONLY = 0x01
EZ_RIGHT = 0x02
EZ_GENERIC_SC = 0x04
EZ_APPROX_MAX = 0x08
EZ_APPROX_DROP = 0x10
EZ_EXTZ_ONLY = 0x40
EZ_REV_CIGAR = 0x80
EZ_SPLICE_FOR = 0x100
EZ_SPLICE_REV = 0x200
EZ_SPLICE_FLANK = 0x400

# kernel launches on this process, by kernel; chip_smoke.py zeroes them
# around the main path to show it went through the kernels
LAUNCHES = {"extd": 0, "exts": 0, "extz": 0, "traceback": 0, "rle": 0}

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


@dataclass(frozen=True)
class ExtsProfile:
    """Per-call scoring of the exts kernel.  The intron state has no
    extension cost, so e2 is 0 and the fields K1 shares keep their extd
    meaning (the boundary after long_thres is -e2 = 0, z-drop's gap term
    is e2 = 0)."""

    q: int
    e: int
    q2: int
    e2: int
    sc_mch: int
    sc_mis: int
    sc_n: int
    long_thres: int
    long_diff: int
    # wm_exts returns an empty result when q2 <= q + e or
    # -min(mat) > 2 * (q + e)
    dead: bool
    noncan: int
    junc_bonus: int

    @property
    def min_intron(self) -> int:
        """The traceback's min_intron_len: long_thres (reference
        ksw2_exts2_sse.c:76-78)."""
        return self.long_thres


def exts_profile(mat, q, e, q2, noncan, junc_bonus) -> ExtsProfile:
    mat = np.asarray(mat, np.int8)
    sc_n = int(mat[24]) if mat[24] != 0 else -e
    dead = q2 <= q + e or -int(mat[1:].min()) > 2 * (q + e)
    long_thres = long_diff = 0
    if not dead:
        long_thres = (q2 - q) // e - 1
        if q2 > q + e + long_thres * e:
            long_thres += 1
        long_diff = long_thres * e - (q2 - q)
    return ExtsProfile(q, e, q2, 0, int(mat[0]), int(mat[1]), sc_n,
                       long_thres, long_diff, dead, noncan, junc_bonus)


@dataclass(frozen=True)
class ExtzProfile:
    """Per-call scoring of the extz kernel (one gap cost, q == q2 and
    e == e2).  Its state is biased unsigned bytes: z = s + 2(q + e), capped
    unsigned at max_sc = mat[0] + 2(q + e) as a byte (0..255)."""

    q: int
    e: int
    sc_mch: int
    sc_mis: int
    sc_n: int
    max_sc: int
    # wm_extz returns an empty result when -min(mat[1:]) > 2 * (q + e)
    dead: bool


def extz_profile(mat, q, e) -> ExtzProfile:
    mat = np.asarray(mat, np.int8)
    sc_n = int(mat[24]) if mat[24] != 0 else -e
    return ExtzProfile(q, e, int(mat[0]), int(mat[1]), sc_n,
                       (int(mat[0]) + 2 * (q + e)) & 255,
                       -int(mat[1:].min()) > 2 * (q + e))


@dataclass
class JobGeometry:
    """Host-side per-job layout of one call: the effective band w, the
    direction buffer (rows of ncol bytes, nbytes per job at dirs_off), the
    ring capacity K3 needs for the band state and the ring span K1 and K4
    need."""

    w_eff: np.ndarray  # (B,) int64
    ncol: np.ndarray  # (B,) int64, wm_extd's n_col
    rows: np.ndarray  # (B,) int64, qlen + tlen - 1
    nbytes: np.ndarray  # (B,) int64, rows * ncol
    dirs_off: np.ndarray  # (B,) int64
    dirs_bytes: int
    cap: int  # K3: power of two >= widest band + 64
    span: int  # K1, K4: ring lanes every row touches (ring_span)
    qlen_max: int  # the longest query (staged in shared memory)


def ring_span(band):
    """The ring lanes K1's and K4's rows touch at most, for jobs whose
    banded rows hold at most `band` = min(qlen, tlen, w + 1) lanes: every
    row's [last_st - 1, max(en, g + 15)] fits in 16 * ((band - 1) // 16)
    + 49 lanes.

    Proof.  Row r holds [st0, en0] with d = en0 - st0 <= band - 1 (en0 <=
    min(r, (r + w) >> 1, tlen - 1) and st0 >= max(r - qlen + 1, (r - w + 1)
    >> 1, 0), and (r + w) >> 1 - (r - w + 1) >> 1 <= w).  With st0 = 16a +
    i (i < 16): st = 16a, en = 16 * ((i + d) // 16) + 16a + 15, so en - st
    <= 16 * ((d + 15) // 16) + 15 <= 16 * (d // 16) + 31; and g + 15 =
    st0 + 16 * (d // 16) + 15, so g + 15 - st <= 16 * (d // 16) + 30.
    st0 grows by at most one a row, so st by 0 or 16: last_st >= st - 16,
    and the span hi - (last_st - 1) + 1 <= 16 * (d // 16) + 31 + 18.  Row
    0 (last_st = -1) touches [-2, 15], 18 lanes.  The ring only needs
    [st - 1, hi] of each row distinct and a lane leaving on the left
    replaced by one no row has touched, which the span of the row and of
    the row before it ensure."""
    return 16 * ((np.asarray(band, np.int64) - 1) // 16) + 49


def job_geometry(ja: np.ndarray, unbanded: bool = False) -> JobGeometry:
    """With `unbanded` (exts) the band is the whole anti-diagonal whatever
    the w column holds: w_eff = qlen + tlen makes every w term vanish."""
    ql = ja[:, 1].astype(np.int64)
    tl = ja[:, 4].astype(np.int64)
    w = ja[:, 6].astype(np.int64)
    if unbanded:
        w_eff = ql + tl
    else:
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
                       int(nbytes.sum()), cap, int(ring_span(band_max)),
                       int(ql.max()) if len(ql) else 0)


# --------------------------------------------------------------------------
# K1: extd wavefront
# --------------------------------------------------------------------------

def _w8(a):
    """Wrap an integer (tensor or int) into int8 range (two's complement)."""
    return ((a + 128) & 255) - 128


def _ubound(r: int, p) -> int:
    # u[r]/v1 boundary value at t == r (reference ksw2_extd2_sse.c:150-155,
    # ksw2_extz2_sse.c:124-129 for the biased extz state)
    if isinstance(p, ExtzProfile):
        return _w8(p.q) if r else 0
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


def _gather_seqs(qpool, tpool, jobs):
    """Each job's reversed query qr[t] = query[qlen-1-t] and its target,
    as the DP reads them, 0-padded: ((B, LQ), (B, LT)) int64."""
    dev = jobs.device
    qo, ql, qrev = jobs[:, 0], jobs[:, 1], jobs[:, 2] != 0
    to, tl, trev = jobs[:, 3], jobs[:, 4], jobs[:, 5] != 0
    LQ = max(1, int(ql.max()))
    LT = max(1, int(tl.max()))
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
    return qr, tg


def extd_dp_plain(qpool, tpool, jobs, dirs_off, ncol, prof: ExtdProfile,
                  flag: int, res, dirs) -> None:
    """Plain PyTorch K1 on the device of its inputs.  jobs: (B, 8) int64
    [qoff qlen qrev toff tlen trev w zdrop] with w already effective;
    dirs_off/ncol: (B,) int64.  Fills res (B, 16) int32 and, with a CIGAR,
    the banded direction bytes of every computed row in dirs.  It keeps
    the band state by absolute lane, so it needs no ring capacity."""
    _dp_plain(qpool, tpool, jobs, dirs_off, ncol, prof, flag, res, dirs)


def splice_sites(tg, tl, junc, flag: int, noncan: int, junc_bonus: int,
                 T: int):
    """Donor and acceptor site scores of every job's lanes (reference
    ksw2_exts2_sse.c:114-166, wm_ksw.cpp wm_exts): (B, T) int64 each, lane
    t at column t + 1 (the plain DP's column layout).  tg: (B, LT) target
    codes as the DP reads them; junc: (B, LT) junction bytes in the same
    orientation, or None.  rev_cigar (left extensions) reads the reversed
    motifs; all zero when no splice strand is requested."""
    dev = tg.device
    B, LT = tg.shape
    t = torch.arange(T, device=dev)[None, :] - 1
    spl_for = bool(flag & EZ_SPLICE_FOR)
    spl_rev = bool(flag & EZ_SPLICE_REV)
    if not (spl_for or spl_rev):
        z = torch.zeros((B, T), dtype=torch.int64, device=dev)
        return z, z.clone()

    def at(src, k):  # src[t + k], -1 outside the buffer
        idx = (t + k).expand(B, T)
        v = src.gather(1, idx.clamp(0, LT - 1))
        return torch.where((idx >= 0) & (idx < LT), v, -1)

    def motif(k0, c0, k1, c1):
        return (at(tg, k0) == c0) & (at(tg, k1) == c1)

    no = torch.zeros((B, T), dtype=torch.bool, device=dev)
    if not (flag & EZ_REV_CIGAR):
        d_can = (motif(1, 2, 2, 3) if spl_for else no) | (
            motif(1, 1, 2, 3) if spl_rev else no)
        d_can2 = (at(tg, 3) == 0) | (at(tg, 3) == 2)
        a_can = (motif(-1, 0, 0, 2) if spl_for else no) | (
            motif(-1, 0, 0, 1) if spl_rev else no)
        a_can2 = (at(tg, -2) == 1) | (at(tg, -2) == 3)
        d_bits, a_bits = (1, 8), (2, 4)
    else:
        d_can = (motif(1, 2, 2, 0) if spl_for else no) | (
            motif(1, 1, 2, 0) if spl_rev else no)
        d_can2 = (at(tg, 3) == 1) | (at(tg, 3) == 3)
        a_can = (motif(-1, 3, 0, 2) if spl_for else no) | (
            motif(-1, 3, 0, 1) if spl_rev else no)
        a_can2 = (at(tg, -2) == 0) | (at(tg, -2) == 2)
        d_bits, a_bits = (2, 4), (1, 8)
    tlc = tl[:, None]
    d_can = d_can & (t >= 0) & (t < tlc - 4)
    a_can = a_can & (t >= 2) & (t < tlc)
    semi = _c_div(-noncan, 2) if flag & EZ_SPLICE_FLANK else 0
    donor = torch.where(d_can & d_can2, 0,
                        torch.where(d_can, semi, -noncan))
    acceptor = torch.where(a_can & a_can2, 0,
                           torch.where(a_can, semi, -noncan))
    if junc is not None:
        def bits(k, pair):
            jv = at(junc, k)
            hit = no
            if spl_for:
                hit = hit | ((jv & pair[0]) != 0)
            if spl_rev:
                hit = hit | ((jv & pair[1]) != 0)
            return hit & (jv >= 0)

        d_j = bits(1, d_bits) & (t >= 0) & (t < tlc - 1)
        a_j = bits(0, a_bits) & (t >= 0) & (t < tlc)
        donor = torch.where(d_j, _w8(donor + junc_bonus), donor)
        acceptor = torch.where(a_j, _w8(acceptor + junc_bonus), acceptor)
    return donor, acceptor


def exts_dp_plain(qpool, tpool, jobs, dirs_off, ncol, prof: ExtsProfile,
                  flag: int, res, dirs, jpool=None, joff=None) -> None:
    """Plain PyTorch K3 on the device of its inputs: the K1 recurrence with
    wm_exts's cell (intron state x2 with acceptor[t] on its candidate and
    donor[t] on its continue test, no y2, no score clamp).  jobs as for
    extd_dp_plain with w = qlen + tlen (unbanded); jpool/joff the optional
    junction bytes (job b's at jpool[joff[b]:], none where joff < 0)."""
    _dp_plain(qpool, tpool, jobs, dirs_off, ncol, prof, flag, res, dirs,
              splice=(jpool, joff))


def extz_dp_plain(qpool, tpool, jobs, dirs_off, ncol, prof: ExtzProfile,
                  flag: int, res, dirs) -> None:
    """Plain PyTorch K4 on the device of its inputs: the K1 recurrence with
    wm_extz's cell (wm_ksw.cpp:1192-1412).  The state u v x y is biased
    unsigned bytes that start at 0; the boundary is q for r > 0; z = s +
    2(q + e) takes signed comparisons for the direction, an unsigned max
    with b and an unsigned min with max_sc; H adds v - (q + e) read
    unsigned; z-drop's gap term is e.  jobs as for extd_dp_plain."""
    _dp_plain(qpool, tpool, jobs, dirs_off, ncol, prof, flag, res, dirs)


def _dp_plain(qpool, tpool, jobs, dirs_off, ncol, prof, flag: int, res, dirs,
              splice=None) -> None:
    """K1 (an ExtdProfile), K4 (an ExtzProfile) or K3 (splice = (jpool,
    joff)) vectorised over jobs and band lanes."""
    dev = jobs.device
    i64 = torch.int64
    B = jobs.shape[0]
    res.zero_()
    ql, tl, w, zd = jobs[:, 1], jobs[:, 4], jobs[:, 6], jobs[:, 7]
    extz = isinstance(prof, ExtzProfile)
    q, e = prof.q, prof.e
    # one gap cost: z-drop's gap term is e
    q2, e2 = (q, e) if extz else (prof.q2, prof.e2)
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
    qr, tg = _gather_seqs(qpool, tpool, jobs)
    LQ, LT = qr.shape[1], tg.shape[1]

    W = int(ncol.max()) + 17  # window: lanes st-1 .. st+W-2
    T = (LT + 15) // 16 * 16 + 32 + W + 2  # column = lane + 1
    # extz's biased state starts at 0
    init1, init2 = (0, 0) if extz else (_w8(-qe), _w8(-qe2))
    # the band state by column, one gather and one store per row:
    # u v x y, then x2 (extd, exts) and y2 (extd), and the score row s last
    n2 = 0 if extz else 1 if splice else 2
    init = [init1] * 4 + [init2] * n2 + [0]
    SA = torch.tensor(init, dtype=i64, device=dev).repeat(B, T, 1)

    def hv(x):  # a u or v byte as H adds it (extz reads it unsigned)
        return (x & 255) - qe if extz else x

    if splice:
        jpool, joff = splice
        junc = None
        if jpool is not None and bool((joff >= 0).any()):
            ct = torch.arange(LT, device=dev)[None, :]
            jix = (joff[:, None] + ct).clamp(0, jpool.numel() - 1)
            junc = torch.where((joff[:, None] >= 0) & (ct < tl[:, None]),
                               jpool[jix].long(), 0)
        SITES = torch.stack(splice_sites(tg, tl, junc, flag, prof.noncan,
                                         prof.junc_bonus, T), -1)
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
        rows = (alive & (r < R)).nonzero().squeeze(1)
        if rows.numel() == 0:
            break
        qlr, tlr, wr = ql[rows], tl[rows], w[rows]
        st0 = torch.maximum(torch.maximum(torch.zeros_like(qlr), r - qlr + 1),
                            torch.div(r - wr + 1, 2, rounding_mode="floor"))
        en0 = torch.minimum(torch.minimum(tlr - 1, torch.full_like(tlr, r)),
                            torch.div(r + wr, 2, rounding_mode="floor"))
        bad = st0 > en0
        # an unbanded (exts) row is never empty
        if not splice and bool(bad.any()):
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
        o = SA[ri, cols]
        u_o, v_o, x_o, y_o = o.unbind(-1)[:4]
        s_o = o[..., -1]
        t = lanes[:, lo]
        # boundary carry into lane st (reference ksw2_extd2_sse.c:150-160)
        ub = _ubound(r, prof)
        carry = ((stb > 0) & (stb - 1 >= last_st[rows])
                 & (stb - 1 <= last_en[rows]))
        x1 = torch.where(carry, x_o[:, 0], init1)
        v1 = torch.where(carry, v_o[:, 0],
                         torch.where(stb > 0, init1, ub))
        xt1 = torch.cat([x1[:, None], x_o[:, 1:W - 1]], 1)
        vt1 = torch.cat([v1[:, None], v_o[:, 1:W - 1]], 1)
        atr = t == r
        ut = torch.where(atr, ub, u_o[:, lo])
        yt = torch.where(atr, init1, y_o[:, lo])
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
        # the cell (wm_extd / wm_exts / wm_extz inner loop)
        cl = cols[:, lo]
        a = _w8(xt1 + vt1)
        b = _w8(yt + ut)
        if extz:
            z = _w8(z + 2 * qe)  # the biased score byte
            cands = (a, b)
        else:
            x21 = torch.where(carry, o[:, 0, 4], init2)
            x2t1 = torch.cat([x21[:, None], o[:, 1:W - 1, 4]], 1)
            a2 = _w8(x2t1 + vt1)
        if splice:
            dn, ac = SITES[ri, cl].unbind(-1)
            cands = (a, b, _w8(a2 + ac))
        elif not extz:
            y2_o = o[..., 5]
            b2 = _w8(torch.where(atr, init2, y2_o[:, lo]) + ut)
            cands = (a, b, a2, b2)
        if not right:
            d = (a > z).long()
            z = za = torch.maximum(z, a)
            for k, c in enumerate(cands[1:], 2):
                d = torch.where(c > z, k, d)
                z = torch.maximum(z, c)
        else:
            d = torch.where(z > a, 0, 1)
            z = za = torch.maximum(z, a)
            for k, c in enumerate(cands[1:], 2):
                d = torch.where(z > c, d, k)
                z = torch.maximum(z, c)
        if extz:
            # wm_extz takes b's max unsigned (_mm_max_epu8), then caps z
            # unsigned at max_sc
            z = torch.where((b & 255) > (za & 255), b, za)
            z = torch.where((z & 255) > prof.max_sc, _w8(prof.max_sc), z)
        elif not splice:
            z = torch.clamp(z, max=prof.sc_mch)
        u_n = _w8(z - vt1)
        v_n = _w8(z - ut)
        zq = _w8(z - q)
        an, bn = _w8(a - zq), _w8(b - zq)
        if not right:
            ax, bx = an > 0, bn > 0
        else:
            ax, bx = an >= 0, bn >= 0
        # extz keeps x and y biased: no - (q + e)
        x_n = _w8(torch.where(ax, an, 0) - (0 if extz else qe))
        y_n = _w8(torch.where(bx, bn, 0) - (0 if extz else qe))
        d = d | (ax.long() << 3) | (bx.long() << 4)
        new = [u_n, v_n, x_n, y_n]
        if not extz:
            a2n = _w8(a2 - _w8(z - q2))
        if splice:
            # the intron state continues past the donor's score, and
            # restarts from it
            a2x = a2n > dn if not right else a2n >= dn
            new.append(_w8(torch.where(a2x, a2n, dn) - qe2))
            d = d | (a2x.long() << 5)
        elif not extz:
            b2n = _w8(b2 - _w8(z - q2))
            if not right:
                a2x, b2x = a2n > 0, b2n > 0
            else:
                a2x, b2x = a2n >= 0, b2n >= 0
            new.append(_w8(torch.where(a2x, a2n, 0) - qe2))
            new.append(_w8(torch.where(b2x, b2n, 0) - qe2))
            d = d | (a2x.long() << 5) | (b2x.long() << 6)
        band = t <= enb[:, None]
        old = o[:, lo]
        upd = torch.where(band[..., None], torch.stack(new, -1),
                          old[..., :len(new)])
        s_w = torch.where(in_s, s_new, s_o[:, lo])[..., None]
        SA[ri, cl] = torch.cat([upd, s_w], -1)
        u_w, v_w = upd[..., 0], upd[..., 1]
        if with_cigar:
            # the band is a prefix of the window (column k = lane stb + k):
            # a write of fixed shape, where lanes past the band rewrite the
            # band's last byte with its own value
            k = torch.minimum(t - stb[:, None], (enb - stb)[:, None])
            pos = dirs_off[rows][:, None] + r * ncol[rows][:, None] + k
            dirs[pos] = d.gather(1, k).to(torch.uint8)
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
                Hn = hv(at(v_f, en0)) - qe
                Hw = Hw.scatter(1, torch.ones_like(en0)[:, None], Hn[:, None])
                max_H, max_t = Hn, torch.zeros_like(en0)
            else:
                Hen = torch.where(en0 > 0,
                                  at(Hw, en0 - 1) + hv(at(u_f, en0)),
                                  at(Hw, en0) + hv(at(v_f, en0)))
                tf = lanes
                inb = (tf >= st0[:, None]) & (tf < en0[:, None])
                Hw = torch.where(inb, Hw + hv(v_f),
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
                H0[rows] = hv(at(v_f, torch.zeros_like(en0))) - qe
                lastH[rows] = 0
                drop = torch.zeros_like(en0, dtype=torch.bool)
            else:
                lt = lastH[rows]
                in1 = (lt >= st0) & (lt <= en0)
                in2 = (lt + 1 >= st0) & (lt + 1 <= en0)
                d0 = hv(at(v_f, lt))
                d1 = hv(at(u_f, lt + 1))
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
        st["zdr"][rows] = torch.where(drop, 1, st["zdr"][rows])
        alive[rows] = alive[rows] & ~drop
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


def _dp_outputs(jobs, flag: int, dirs_bytes: int):
    """res (B, 16) int32 and the direction buffer of a DP call."""
    res = torch.empty((jobs.shape[0], 16), dtype=torch.int32,
                      device=jobs.device)
    with_cigar = not (flag & EZ_SCORE_ONLY)
    dirs = torch.empty(max(1, dirs_bytes if with_cigar else 1),
                       dtype=torch.uint8, device=jobs.device)
    return res, dirs


# K1's and K4's launch variants (csrc/ext_common.cuh WM_EXT_VARIANTS lists
# the same): threads a block, and the ring slots a thread keeps in
# registers, four blocks an SM.  A ring none of them holds keeps its slot
# state in memory (spt 0) at EXT_MEM_THREADS threads.
EXT_VARIANTS = {128: (1, 2, 3, 4, 5, 6, 7, 8)}
EXT_MEM_THREADS = 512
# the longest query K1 and K4 stage in shared memory; a longer one is read
# from the device pool in every cell
EXT_QSTAGE_MAX = 64 * 1024
# dynamic shared memory a K1 or K4 block may take with its slot state in
# memory; wider rings keep that state in a global scratch slot per block
EXT_SMEM_MAX = 200 * 1024
# csrc/ext_common.cuh's layout, which its launch checks these sizes
# against: the double-buffered row exchange (2 x 528 bytes), and the memory
# path's slot state (three 32-bit words a slot)
_EXT_XCH_BYTES = 1056
_EXT_MEM_BYTES = 12


@dataclass(frozen=True)
class ExtGeometry:
    """A launch of K1, K4 (ext_geometry) or K3 (exts_geometry): threads a
    block, ring slots a thread in registers (0: the slot state in memory),
    the ring's lanes, the query bytes staged in shared memory, and where
    the memory path's state lies.  K1's and K4's layout serves both cells
    and both row-max modes."""

    threads: int
    spt: int
    ring: int
    qstage: int
    mem_smem: bool
    smem: int  # dynamic shared bytes a block
    scratch: int  # global scratch bytes a block

    @property
    def path(self) -> str:
        if self.spt:
            return f"reg{self.threads}x{self.spt}"
        return "mem-smem" if self.mem_smem else "mem-global"


def ext_geometry(span: int, qlen_max: int) -> ExtGeometry:
    """K1's and K4's launch for a call whose rows touch `span` ring lanes
    (JobGeometry.span) and whose longest query is qlen_max: 128 threads
    keep ceil(span / 128) slots each in registers, the ring their 128 x
    slots lanes; a span no register variant holds takes the memory path at
    EXT_MEM_THREADS threads, the ring a multiple of them (the slot state in
    shared memory when it fits, else in global scratch)."""
    nt = 128
    spt = max(1, -(-span // nt))
    if spt not in EXT_VARIANTS.get(nt, ()):
        nt, spt = EXT_MEM_THREADS, 0
    ring = nt * (spt or max(1, -(-span // nt)))
    qstage = min((qlen_max + 15) // 16 * 16, EXT_QSTAGE_MAX)
    return _launch(nt, spt, ring, qstage, _EXT_XCH_BYTES, _EXT_MEM_BYTES,
                   EXT_SMEM_MAX)


def _launch(nt, spt, ring, qstage, xch_bytes, mem_bytes, smem_max):
    """The ExtGeometry of a launch in the layout K1, K3 and K4 share: the
    row exchange (xch_bytes), the warp edges (an 8-byte word a warp of the
    ring, double-buffered) and the staged query in dynamic shared
    memory, plus, on the memory path (spt 0), mem_bytes a slot in shared
    memory up to smem_max bytes a block, else in global scratch."""
    smem = xch_bytes + 2 * (ring // 32) * 8 + qstage
    mem = ring * mem_bytes if spt == 0 else 0
    mem_smem = spt == 0 and smem + mem <= smem_max
    return ExtGeometry(nt, spt, ring, qstage, mem_smem,
                       smem + (mem if mem_smem else 0),
                       0 if mem_smem else mem)


def extd_occupancy(geo: ExtGeometry) -> int:
    """Blocks of K1 one SM holds at once at the launch `geo`."""
    import ctypes

    from . import _build

    n = ctypes.c_int(0)
    rc = _build.load().wm_extd_occupancy(geo.threads, geo.spt, geo.smem,
                                         ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"extd occupancy query failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    return n.value


def ext_launch(lib, mode: str, geo: ExtGeometry, prof, flag: int, qpool,
               tpool, jobs, dirs_off, dirs, res, stream) -> int:
    """Calls K1's (mode "extd") or K4's ("extz") C launch entry of `lib`
    at the launch `geo` on contiguous tensors, with the global scratch the
    launch needs; returns the entry's CUDA error code.  extd_dp and extz_dp
    call it with the card's library; the CPU tests with the same sources
    built against a stub runtime (tools/cuda_stub)."""
    if jobs.dtype != torch.int64 or jobs.shape[1:] != (8,):
        raise ValueError("jobs must be (B, 8) int64")
    B = jobs.shape[0]
    scratch = torch.empty(max(1, B * geo.scratch), dtype=torch.uint8,
                          device=jobs.device)
    launch = (qpool.data_ptr(), tpool.data_ptr(), jobs.data_ptr(), B,
              dirs_off.data_ptr(), dirs.data_ptr(), res.data_ptr(),
              scratch.data_ptr(), geo.ring, geo.threads, geo.spt,
              geo.qstage, int(geo.mem_smem), geo.smem, geo.scratch)
    if mode == "extd":
        return lib.wm_extd_launch(
            *launch, prof.q, prof.e, prof.q2, prof.e2, prof.sc_mch,
            prof.sc_mis, prof.sc_n, prof.long_thres, prof.long_diff,
            int(prof.dead), flag, stream)
    return lib.wm_extz_launch(
        *launch, prof.q, prof.e, prof.sc_mch, prof.sc_mis, prof.sc_n,
        prof.max_sc, int(prof.dead), flag, stream)


# K3's launch variants (csrc/exts.cu WM_K3_VARIANTS lists the same):
# threads a block, and the ring slots a thread keeps in registers, none of
# which spills (chip_smoke.py's phase 1 prints ptxas's registers).  A ring
# none of them holds keeps its slot state in memory (spt 0) at
# K3_MEM_THREADS threads.
K3_VARIANTS = {256: (1,), 512: (1, 2, 4)}
K3_MEM_THREADS = 512
# the longest query K3 stages in shared memory; a longer one is read from
# the device pool in every cell
K3_QSTAGE_MAX = 64 * 1024
# dynamic shared memory a K3 block may take with its slot state in memory;
# wider rings keep that state in a global scratch slot per block
K3_SMEM_MAX = 200 * 1024
# csrc/exts.cu's layout, which its launch checks these sizes against: the
# double-buffered row exchange (2 x 528 bytes), and the memory path's slot
# state (nine int8 rows and an int32 H row)
_K3_XCH_BYTES = 1056
_K3_MEM_BYTES = 13


def exts_geometry(cap: int, qlen_max: int) -> ExtGeometry:
    """K3's launch for a call whose widest band needs `cap` ring lanes and
    whose longest query is qlen_max: the threads follow the band, cap
    clipped to 256-512, and a thread takes the slots that fill the ring.
    A ring no register variant holds takes the memory path (the slot state
    in shared memory when it fits, else in global scratch)."""
    nt = min(512, max(256, cap))
    spt = max(1, cap // nt)
    if spt not in K3_VARIANTS.get(nt, ()):
        nt, spt = K3_MEM_THREADS, 0
    ring = nt * spt if spt else max(cap, nt)
    qstage = min((qlen_max + 15) // 16 * 16, K3_QSTAGE_MAX)
    return _launch(nt, spt, ring, qstage, _K3_XCH_BYTES, _K3_MEM_BYTES,
                   K3_SMEM_MAX)


def extd_dp(qpool, tpool, jobs, dirs_off, ncol, geo: ExtGeometry,
            prof: ExtdProfile, flag: int, dirs_bytes: int):
    """K1 at the launch `geo` (ext_geometry).  Returns (res (B, 16) int32,
    dirs (dirs_bytes,) uint8) on the device of `jobs`.  CUDA tensors launch
    csrc/extd.cu; CPU tensors run extd_dp_plain."""
    return _ext_dp("extd", qpool, tpool, jobs, dirs_off, ncol, geo, prof,
                   flag, dirs_bytes)


def _ext_dp(mode, qpool, tpool, jobs, dirs_off, ncol, geo, prof, flag,
            dirs_bytes):
    dev = jobs.device
    res, dirs = _dp_outputs(jobs, flag, dirs_bytes)
    if dev.type == "cpu":
        plain = extd_dp_plain if mode == "extd" else extz_dp_plain
        plain(qpool, tpool, jobs, dirs_off, ncol, prof, flag, res, dirs)
        return res, dirs
    _check_kernel_args(qpool, tpool, jobs, dirs_off)
    from . import _build

    res.zero_()
    rc = ext_launch(_build.load(), mode, geo, prof, flag, qpool, tpool,
                    jobs, dirs_off, dirs, res,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{mode} kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    count(LAUNCHES, mode)
    return res, dirs


def exts_dp(qpool, tpool, jobs, dirs_off, ncol, geo: ExtGeometry,
            prof: ExtsProfile, flag: int, dirs_bytes: int, jpool=None,
            joff=None):
    """K3 at the launch `geo` (exts_geometry).  Returns (res (B, 16) int32,
    dirs (dirs_bytes,) uint8) on the device of `jobs`; jobs carry w = qlen
    + tlen (unbanded) for K2, which the kernel ignores.  jpool/joff:
    optional junction bytes per job (null on the engine path).  CUDA
    tensors launch csrc/exts.cu; CPU tensors run exts_dp_plain."""
    dev = jobs.device
    res, dirs = _dp_outputs(jobs, flag, dirs_bytes)
    if dev.type == "cpu":
        exts_dp_plain(qpool, tpool, jobs, dirs_off, ncol, prof, flag, res,
                      dirs, jpool, joff)
        return res, dirs
    _check_kernel_args(qpool, tpool, jobs, dirs_off)
    if jpool is not None:
        _check_kernel_args(jpool, joff)
    from . import _build

    if jobs.dtype != torch.int64 or jobs.shape[1:] != (8,):
        raise ValueError("jobs must be (B, 8) int64")
    B = jobs.shape[0]
    scratch = torch.empty(max(1, B * geo.scratch), dtype=torch.uint8,
                          device=dev)
    res.zero_()
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.wm_exts_launch(
        qpool.data_ptr(), tpool.data_ptr(), jobs.data_ptr(), B,
        dirs_off.data_ptr(), jpool.data_ptr() if jpool is not None else None,
        joff.data_ptr() if jpool is not None else None, dirs.data_ptr(),
        res.data_ptr(), scratch.data_ptr(), geo.ring, geo.threads, geo.spt,
        geo.qstage, int(geo.mem_smem), geo.smem, geo.scratch,
        prof.q, prof.e, prof.q2, prof.sc_mch, prof.sc_mis, prof.sc_n,
        prof.long_thres, prof.long_diff, prof.noncan, prof.junc_bonus,
        int(prof.dead), flag, stream)
    if rc != 0:
        raise RuntimeError(f"exts kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    count(LAUNCHES, "exts")
    return res, dirs


def extz_dp(qpool, tpool, jobs, dirs_off, ncol, geo: ExtGeometry,
            prof: ExtzProfile, flag: int, dirs_bytes: int):
    """K4 at the launch `geo` (ext_geometry).  Returns (res (B, 16) int32,
    dirs (dirs_bytes,) uint8) on the device of `jobs`.  CUDA tensors launch
    csrc/extz.cu; CPU tensors run extz_dp_plain."""
    return _ext_dp("extz", qpool, tpool, jobs, dirs_off, ncol, geo, prof,
                   flag, dirs_bytes)


# --------------------------------------------------------------------------
# start selection (plain torch on the device)
# --------------------------------------------------------------------------

def select_starts(res, jobs, end_bonus, extz_only: bool, dead: bool,
                  spliced: bool = False):
    """Traceback start (i0, j0) per job, (B, 2) int32 (reference wm_ksw.cpp
    wm_extd and wm_exts tails): full reach unless z-dropped; with
    EXTZ_ONLY, the query end when mqe + end_bonus > max (extd; exts has no
    such rule); else the running max; -1 = no CIGAR."""
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
        reach = (~zdr) & (mqe + end_bonus > mx) & (not spliced)
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

def traceback_plain(dirs, dirs_off, jobs, ncol, start, ops, fin,
                    min_intron: int = 0) -> None:
    """Plain PyTorch K2: every job walks its direction rows from (i0, j0)
    over descending anti-diagonals (reference ksw_backtrack, is_rot=1,
    force-state band clamp).  Writes the op byte (0 M, 1 I, 2 D, and 3 N
    for the long-gap state when min_intron > 0: the spliced form) at
    ops[b, r] for each visited diagonal r (the rest stay 255) and the
    remaining (i, j) into fin (B, 2) int32."""
    ops.fill_(255)
    i = start[:, 0].long().clone()
    j = start[:, 1].long().clone()
    state = torch.zeros_like(i)
    ql, tl, w = jobs[:, 1], jobs[:, 4], jobs[:, 6]
    nd = dirs.numel()
    while True:
        rows = ((i >= 0) & (j >= 0)).nonzero().squeeze(1)
        if rows.numel() == 0:
            break
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
        if min_intron > 0:
            op = torch.where(s3 == 3, 3, op)
        ops[rows, r] = op.to(torch.uint8)
        i[rows] = ii - (op != 1).long()
        j[rows] = jj - (op < 2).long()
        state[rows] = s3
    fin[:, 0] = i.to(torch.int32)
    fin[:, 1] = j.to(torch.int32)


def traceback(dirs, dirs_off, jobs, ncol, start, n_ops: int,
              min_intron: int = 0):
    """K2, spliced when min_intron > 0.  Returns (ops (B, n_ops) uint8,
    fin (B, 2) int32); n_ops is a multiple of 4 covering every job's
    diagonals."""
    dev = dirs.device
    B = jobs.shape[0]
    ops = torch.empty((B, n_ops), dtype=torch.uint8, device=dev)
    fin = torch.empty((B, 2), dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        traceback_plain(dirs, dirs_off, jobs, ncol, start, ops, fin,
                        min_intron)
        return ops, fin
    _check_kernel_args(dirs, dirs_off, jobs, start)
    from . import _build

    ops.fill_(255)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.wm_traceback_launch(
        dirs.data_ptr(), dirs_off.data_ptr(), jobs.data_ptr(),
        start.data_ptr(), B, ops.data_ptr(), n_ops, fin.data_ptr(),
        min_intron, stream)
    if rc != 0:
        raise RuntimeError(f"traceback kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    count(LAUNCHES, "traceback")
    return ops, fin


# --------------------------------------------------------------------------
# R1: the CIGARs of K2's op rows
# --------------------------------------------------------------------------

def cigar_rle_plain(ops, fin, start, rev_cigar: bool, min_intron: int = 0):
    """Plain PyTorch R1 on the device of its inputs: job b's CIGAR from
    K2's op row ops[b] (B, n_ops) uint8, its remaining (i, j) fin[b] and
    its walk's start[b] (both (B, 2) int32), as native.rle_ops_blob and
    rle_ops_blob4 decode the packed row: slots 0 ... i0 + j0 from the top,
    idle ones (255) dropped, equal ops merged into runs; then a D run of i
    + 1 (N when min_intron > 0 and i >= min_intron) and an I run of j + 1
    where i, j >= 0, each merged into the run before it when the op is the
    same; reversed unless rev_cigar.  Slots above i0 + j0 are not read: K2
    writes none there, and none at all when i0 or j0 is negative.  Returns
    (blob (total,) int32 holding the BAM words len << 4 | op as uint32
    bits, off (B,) int64, len (B,) int32), job b's words at blob[off[b]]
    ... blob[off[b] + len[b] - 1]."""
    dev = ops.device
    B, n = ops.shape
    i0, j0 = start[:, 0].long(), start[:, 1].long()
    top = torch.where((i0 >= 0) & (j0 >= 0), torch.clamp(i0 + j0, max=n - 1),
                      -1)
    kept = (ops != 255) & (torch.arange(n, device=dev)[None, :]
                           <= top[:, None])
    rows, cols = kept.nonzero(as_tuple=True)
    fi, fj = fin[:, 0].long(), fin[:, 1].long()
    b = torch.arange(B, device=dev)
    im, jm = fi >= 0, fj >= 0
    # walk order: a job's slots from the top, then its i and j remainders
    span_ = n + 2
    key = torch.cat([rows * span_ + n - 1 - cols, (b * span_ + n)[im],
                     (b * span_ + n + 1)[jm]])
    iop = (torch.where(fi >= min_intron, 3, 2) if min_intron > 0
           else torch.full_like(fi, 2))
    op = torch.cat([ops[rows, cols].long(), iop[im], torch.ones_like(fj[jm])])
    ln = torch.cat([torch.ones_like(rows), fi[im] + 1, fj[jm] + 1])
    order = torch.argsort(key)
    key, op, ln = key[order], op[order], ln[order]
    job = torch.div(key, span_, rounding_mode="floor")
    new = torch.ones_like(job, dtype=torch.bool)
    new[1:] = (job[1:] != job[:-1]) | (op[1:] != op[:-1])
    rid = torch.cumsum(new.long(), 0) - 1
    nr = int(new.sum())
    rlen = torch.zeros(nr, dtype=torch.int64, device=dev).index_add_(
        0, rid, ln)
    rjob, rop = job[new], op[new]
    cnt = torch.bincount(rjob, minlength=B)
    off = torch.cumsum(cnt, 0) - cnt
    k = torch.arange(nr, device=dev) - off[rjob]
    pos = off[rjob] + (k if rev_cigar else cnt[rjob] - 1 - k)
    # the length's low 28 bits: the uint32 word's wrap
    word = torch.empty(nr, dtype=torch.int64, device=dev)
    word[pos] = ((rlen & 0xFFFFFFF) << 4) | rop
    word = torch.where(word >= 1 << 31, word - (1 << 32), word)
    return word.to(torch.int32), off, cnt.to(torch.int32)


def rle_launch(lib, ops, fin, start, rev_cigar: bool, min_intron: int, blob,
               off, ln, stream) -> int:
    """Calls R1's C launch entry of `lib` (csrc/cigar.cu) on contiguous
    tensors; returns its CUDA error code.  cigar_rle calls it with the
    card's library; the CPU tests with the source built against a stub
    runtime (tools/cuda_stub)."""
    B, n_ops = ops.shape
    return lib.wm_cigar_rle_launch(
        ops.data_ptr(), n_ops, B, fin.data_ptr(), start.data_ptr(),
        int(rev_cigar), min_intron, blob.data_ptr(), blob.numel(),
        off.data_ptr(), ln.data_ptr(), stream)


def cigar_rle(ops, fin, start, rev_cigar: bool, min_intron: int = 0,
              cap: int | None = None):
    """R1: the CIGARs of K2's output (cigar_rle_plain has the semantics).
    Returns (blob, off, len) on the device of ops; CUDA tensors launch
    csrc/cigar.cu into a blob of `cap` words (by default B x (n_ops + 2):
    a job reads at most n_ops slots and adds two remainder runs), CPU
    tensors run cigar_rle_plain, whose blob is just long enough.  Either
    way the runs end at off[-1] + len[-1]; the kernel drops words past
    cap."""
    if ops.dtype != torch.uint8 or ops.dim() != 2:
        raise ValueError("ops must be (B, n_ops) uint8")
    B, n_ops = ops.shape
    for t in (fin, start):
        if t.dtype != torch.int32 or t.shape != (B, 2):
            raise ValueError("fin and start must be (B, 2) int32")
    if ops.device.type == "cpu":
        return cigar_rle_plain(ops, fin, start, rev_cigar, min_intron)
    _check_kernel_args(ops, fin, start)
    from . import _build

    dev = ops.device
    cap = B * (n_ops + 2) if cap is None else cap
    blob = torch.empty(max(1, cap), dtype=torch.int32, device=dev)
    off = torch.empty(B, dtype=torch.int64, device=dev)
    ln = torch.empty(B, dtype=torch.int32, device=dev)
    rc = rle_launch(_build.load(), ops, fin, start, rev_cigar, min_intron,
                    blob, off, ln, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cigar_rle kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    count(LAUNCHES, "rle")
    return blob, off, ln


def pack_ops(ops):
    """Pack op bytes 4 per byte, 2 bits each (idle 255 -> 3), the layout
    native.rle_ops_blob decodes (the oracle R1 is held to)."""
    B, n = ops.shape
    o = torch.clamp(ops, max=3).view(B, n // 4, 4)
    return (o[..., 0] | (o[..., 1] << 2) | (o[..., 2] << 4)
            | (o[..., 3] << 6)).contiguous()


def pack_ops4(ops):
    """Pack op bytes 2 per byte, 4 bits each (idle 255 -> 15), the layout
    native.rle_ops_blob4 decodes (the spliced ops use all of 0-3)."""
    B, n = ops.shape
    o = torch.clamp(ops, max=15).view(B, n // 2, 2)
    return (o[..., 0] | (o[..., 1] << 4)).contiguous()


# --------------------------------------------------------------------------
# pooled calls
# --------------------------------------------------------------------------

# guards the index objects' device copies of the reference: engines on
# several host threads share one index
_CODES_LOCK = threading.Lock()


class PoolContext:
    """The sequence pools of one mapping batch on the device: the batch's
    read-strand pool and the reference codes.  The reference upload is kept
    on the index object (one per device) so later batches, and engines on
    other host threads, reuse it: it is complete before any stream reads
    it, and each stream that reads it is recorded on it."""

    def __init__(self, qpool_np: np.ndarray, mi, device: torch.device):
        self.device = torch.device(device)
        self.qpool = torch.from_numpy(qpool_np).to(self.device)
        key = str(self.device)
        with _CODES_LOCK:
            cache = mi.device_codes
            if key not in cache:
                ref = torch.from_numpy(
                    np.ascontiguousarray(mi.codes, np.uint8)).to(self.device)
                if ref.is_cuda:
                    torch.cuda.current_stream(self.device).synchronize()
                cache[key] = ref
            self.ref = cache[key]
        if self.ref.is_cuda:
            self.ref.record_stream(torch.cuda.current_stream(self.device))
        self._ranges = [_addr_range(qpool_np), _addr_range(mi.codes)]

    def resolve(self, js) -> tuple[int, int] | None:
        """(pool, offset) of a JobSeq's view: pool 0 is the read pool, 1
        the reference codes; None when the view lies in neither."""
        v = js.view
        if v.dtype != np.uint8 or v.ndim != 1 or (len(v) > 1
                                                  and v.strides[0] != 1):
            return None
        a = v.__array_interface__["data"][0]
        for sel, (lo, hi) in enumerate(self._ranges):
            if lo <= a and a + v.nbytes <= hi:
                return sel, a - lo
        return None


def _addr_range(a: np.ndarray) -> tuple[int, int]:
    lo = a.__array_interface__["data"][0]
    return lo, lo + a.nbytes


def junction_pool(juncs, device):
    """Per-job junction bytes (a list with one uint8 array or None per job)
    as K3 reads them: (jpool, joff) with job b's bytes at jpool[joff[b]:]
    and joff[b] = -1 for none; (None, None) when no job has any."""
    if juncs is None or all(j is None for j in juncs):
        return None, None
    lens = [0 if j is None else len(j) for j in juncs]
    offs = np.cumsum([0] + lens)[:-1]
    jpool = np.concatenate([np.asarray(j, np.uint8) for j in juncs
                            if j is not None] + [np.zeros(1, np.uint8)])
    joff = np.where([j is None for j in juncs], -1, offs).astype(np.int64)
    return (torch.from_numpy(jpool).to(device),
            torch.from_numpy(joff).to(device))


class DevCallPooled:
    """One pooled batch of extd, exts or extz jobs on the device.

    jobs: (B0, 8) int array of (qoff, qlen, qrev, toff, tlen, trev, w, zdrop)
    rows (the engine's flat job columns; qoff indexes the read pool, toff the
    reference).  mat/q/e/q2/e2 the scoring, end_bonus a scalar or per-job
    array, flag the ksw flags.  splice = (noncan, junc_bonus) selects the
    exts kernel (e2 and the w column are then unused: exts is unbanded),
    whatever the flag's splice bits say, as the JAX package's signature
    does; juncs optionally carries one junction-byte array per job (None
    for none), sliced and oriented as the DP reads the target.  Without
    splice, one gap cost (q == q2 and e == e2) selects extz, as the JAX
    package chooses it; any other profile extd.  Launches everything
    asynchronously; collect_blob() waits and returns flat arrays (the
    engine's deliver columns), collect() one native.ExtResult a job
    (the generator path's results)."""

    def __init__(self, pools: PoolContext, jobs, mat, q, e, q2, e2,
                 end_bonus, flag, splice=None, juncs=None):
        flag = int(flag)
        if flag & EZ_GENERIC_SC:
            raise NotImplementedError("generic scoring matrices are not "
                                      "supported by the extension kernels")
        ja = np.ascontiguousarray(jobs, np.int64).reshape(-1, 8).copy()
        B0 = len(ja)
        self.B0 = B0
        self.with_cigar = not (flag & EZ_SCORE_ONLY)
        self.extz_only = bool(flag & EZ_EXTZ_ONLY)
        self.rev_cigar = bool(flag & EZ_REV_CIGAR)
        self.spliced = splice is not None
        self.end_bonus = np.broadcast_to(
            np.asarray(end_bonus, np.int64), (B0,)).copy()
        geo = job_geometry(ja, unbanded=self.spliced)
        ja[:, 6] = geo.w_eff
        self.geometry = geo
        dev = pools.device
        self.device = dev
        with span(STATS, "dispatch_upload"):
            jobs_t = torch.from_numpy(ja).to(dev)
            off_t = torch.from_numpy(geo.dirs_off).to(dev)
            ncol_t = torch.from_numpy(geo.ncol).to(dev)
            if self.spliced:
                jpool, joff = junction_pool(juncs, dev)
        if self.spliced:
            prof = exts_profile(mat, q, e, q2, *splice)
            self.min_intron = prof.min_intron
            res, dirs = exts_dp(pools.qpool, pools.ref, jobs_t, off_t, ncol_t,
                                exts_geometry(geo.cap, geo.qlen_max),
                                prof, flag, geo.dirs_bytes, jpool, joff)
        elif q == q2 and e == e2:
            prof = extz_profile(mat, q, e)
            self.min_intron = 0
            res, dirs = extz_dp(pools.qpool, pools.ref, jobs_t, off_t,
                                ncol_t, ext_geometry(geo.span, geo.qlen_max),
                                prof, flag, geo.dirs_bytes)
        else:
            prof = extd_profile(mat, q, e, q2, e2)
            self.min_intron = 0
            res, dirs = extd_dp(pools.qpool, pools.ref, jobs_t, off_t,
                                ncol_t, ext_geometry(geo.span, geo.qlen_max),
                                prof, flag, geo.dirs_bytes)
        if self.with_cigar:
            # pageable, after the DP's launch: mostly the wait for it
            with span(STATS, "dispatch_bonus"):
                eb = torch.from_numpy(self.end_bonus).to(dev)
            start = select_starts(res, jobs_t, eb, self.extz_only, prof.dead,
                                  self.spliced)
            # rows of 16-byte multiples: R1 reads them 16 bytes a lane
            n_ops = max(16, (int(geo.rows.max()) + 15) // 16 * 16)
            ops, fin = traceback(dirs, off_t, jobs_t, ncol_t, start, n_ops,
                                 self.min_intron)
            # a job has at most rows + 2 runs: its walk's ops and the two
            # remainders
            self.cap = int(geo.rows.sum()) + 2 * B0
            self.blob, off, ln = cigar_rle(ops, fin, start, self.rev_cigar,
                                           self.min_intron, self.cap)
            out = torch.cat([res.view(torch.uint8),
                             off.view(torch.uint8).view(B0, 8),
                             ln.view(torch.uint8).view(B0, 4)], 1)
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
        """Wait for the call and take its results: (res9 (B0, 9) int32 in
        the engine deliver column order, CIGAR blob uint32 | None, per-job
        blob offsets int64, lengths int32, reach_end (B0,) int32)."""
        if self.event is not None:
            with span(STATS, "collect_sync"):
                self.event.synchronize()
        with span(STATS, "collect_decode"):
            buf = self.host.numpy()
            res9 = np.ascontiguousarray(buf[:, :36]).view(np.int32)
            blob = off = ln = None
            if self.with_cigar:
                off = np.ascontiguousarray(buf[:, 64:72]).view(np.int64)[:, 0]
                ln = np.ascontiguousarray(buf[:, 72:76]).view(np.int32)[:, 0]
            reach = np.zeros(self.B0, np.int32)
            if self.with_cigar and self.extz_only and not self.spliced:
                reach = ((res9[:, 1] == 0)
                         & (res9[:, 4] + self.end_bonus > res9[:, 0])
                         ).astype(np.int32)
        runs = 0
        if self.with_cigar:
            runs = int(off[-1]) + int(ln[-1])
            with span(STATS, "collect_copy"):
                blob = self._runs(runs)
        count(STATS, "collect_runs", runs)
        count(STATS, "collect_d2h_bytes", buf.nbytes + 4 * runs)
        return res9, blob, off, ln, reach

    def _runs(self, total: int) -> np.ndarray:
        """The call's first `total` CIGAR words on the host: from the card,
        one copy of just those words into pinned memory, on a stream of its
        own (the call's stream may hold later calls' kernels by now)."""
        if total > self.cap:
            raise RuntimeError(f"cigar_rle wrote {total} runs into a blob "
                               f"of {self.cap}")
        if self.event is None:
            return self.blob[:total].numpy().view(np.uint32)
        if total == 0:
            return np.zeros(0, np.uint32)
        host = torch.empty(total, dtype=torch.int32, pin_memory=True)
        with torch.cuda.stream(torch.cuda.Stream(self.device)):
            host.copy_(self.blob[:total])
        return host.numpy().view(np.uint32)

    def collect(self) -> list:
        """Wait for the call and return one native.ExtResult per job, in job
        order: the nine result fields, reach_end (set as the oracle sets it:
        extz-only, not z-dropped, mqe + end_bonus > max) and the CIGAR."""
        from .. import native

        res9, blob, off, ln, reach = self.collect_blob()
        out = []
        for i, v in enumerate(res9.tolist()):
            r = native.ExtResult.__new__(native.ExtResult)
            (r.max, zd, r.max_q, r.max_t, r.mqe, r.mqe_t, r.mte, r.mte_q,
             r.score) = v
            r.zdropped = bool(zd)
            r.reach_end = bool(reach[i])
            r.cigar = (np.zeros(0, np.uint32) if blob is None
                       else blob[off[i]:off[i] + ln[i]].copy())
            out.append(r)
        return out
