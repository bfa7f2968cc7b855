"""Random extd, extz and spliced (exts) job batches, and K1/K3/K4 with K2
held against their plain versions on the same device tensors, and against
the native oracle on a sample.

Shared by the on-card tests (tests/test_torch_gpu.py) and chip_smoke.py.
The kernels are integer DP, so every comparison is exact: the errors that
check_against_plain returns are 0 when the kernels are right.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kernels as K


def mutate(rng: np.random.Generator, t: np.ndarray, err: float) -> np.ndarray:
    """A copy of t with substitutions and 1-base indels at rate err."""
    out = []
    for i, x in enumerate(rng.random(len(t))):
        if x < err / 3:
            continue
        if x < 2 * err / 3:
            out.append(rng.integers(0, 4))
        out.append((t[i] + 1 + rng.integers(0, 3)) % 4 if x < err else t[i])
    return np.array(out, np.uint8)


def random_jobs(rng: np.random.Generator, lens, ws, zdrops,
                dissimilar: bool = False, err: float = 0.08,
                n_frac: float = 0.02):
    """Sequence pools and (B, 8) job rows (qoff, qlen, qrev, toff, tlen,
    trev, w, zdrop): random targets of the given lengths (n_frac of their
    bases N) against mutated copies as queries.  With `dissimilar`, one
    unrelated pair (150 vs 140 bases) ends the batch: the approx walk's tie
    rule shows only on such pairs.  Every third query and every fourth
    target is reversed; ws and zdrops are scalars or one value per job.
    Returns (qpool, tpool, jobs, queries, targets)."""
    qs, ts = [], []
    for n in lens:
        t = rng.integers(0, 4, int(n)).astype(np.uint8)
        t[rng.random(len(t)) < n_frac] = 4
        qs.append(mutate(rng, t, err))
        ts.append(t)
    if dissimilar:
        qs.append(rng.integers(0, 4, 150).astype(np.uint8))
        ts.append(rng.integers(0, 4, 140).astype(np.uint8))
    B = len(qs)
    jobs = np.zeros((B, 8), np.int64)
    jobs[:, 0] = np.cumsum([0] + [len(x) for x in qs])[:-1]
    jobs[:, 1] = [len(x) for x in qs]
    jobs[:, 2] = np.arange(B) % 3 == 1
    jobs[:, 3] = np.cumsum([0] + [len(x) for x in ts])[:-1]
    jobs[:, 4] = [len(x) for x in ts]
    jobs[:, 5] = np.arange(B) % 4 == 2
    jobs[:, 6] = ws
    jobs[:, 7] = zdrops
    qpool = np.concatenate(qs + [np.zeros(16, np.uint8)])
    tpool = np.concatenate(ts + [np.zeros(16, np.uint8)])
    return qpool, tpool, jobs, qs, ts


def spliced_jobs(rng: np.random.Generator, B: int, rev: bool = False,
                 junc_frac: float = 1 / 3, exon_total=(300, 800),
                 n_exons=(2, 4), intron_len=(100, 1500), sub: float = 0.04,
                 ind: float = 0.02):
    """Pools and (B, 8) job rows of spliced pairs: each query is 2-4 exons
    (300-800 bases in all) at `sub` substitutions and `ind` 1-base indels;
    its target holds the same exons joined by canonical introns of 100-1500
    bases, GT..AG or (reverse strand) CT..AC.  With `rev` every job reads
    its query and target reversed from the pools, as the engine's left
    extensions do (the DP then meets the reversed motifs that rev_cigar
    scores).  junc_frac of the jobs get junction bytes (values 1-15
    at 5% of the target positions).  w is -1 (exts is unbanded).
    Returns (qpool, tpool, jobs, queries, targets, juncs) with queries and
    targets as the DP reads them and juncs per job (None for none)."""
    qs, ts, js = [], [], []
    for i in range(B):
        k = int(rng.integers(n_exons[0], n_exons[1] + 1))
        total = int(rng.integers(exon_total[0], exon_total[1] + 1))
        cuts = np.sort(rng.choice(np.arange(30, total - 29), k - 1,
                                  replace=False))
        lens = np.diff(np.concatenate([[0], cuts, [total]]))
        exons = [rng.integers(0, 4, int(n)).astype(np.uint8) for n in lens]
        parts = [exons[0]]
        for ex in exons[1:]:
            intron = rng.integers(0, 4, int(rng.integers(*intron_len))
                                  ).astype(np.uint8)
            if rng.random() < 0.5:
                intron[:2], intron[-2:] = (2, 3), (0, 2)  # GT..AG
            else:
                intron[:2], intron[-2:] = (1, 3), (0, 1)  # CT..AC
            parts += [intron, ex]
        t = np.concatenate(parts)
        qs.append(mutate_rates(rng, np.concatenate(exons), sub, ind))
        ts.append(t)
        js.append(((rng.random(len(t)) < 0.05)
                   * rng.integers(1, 16, len(t))).astype(np.uint8)
                  if rng.random() < junc_frac else None)
    jobs = np.zeros((B, 8), np.int64)
    jobs[:, 0] = np.cumsum([0] + [len(x) for x in qs])[:-1]
    jobs[:, 1] = [len(x) for x in qs]
    jobs[:, 2] = rev
    jobs[:, 3] = np.cumsum([0] + [len(x) for x in ts])[:-1]
    jobs[:, 4] = [len(x) for x in ts]
    jobs[:, 5] = rev
    jobs[:, 6] = -1
    jobs[:, 7] = rng.choice([100, 200, 400], B)
    qpool = np.concatenate(qs + [np.zeros(16, np.uint8)])
    tpool = np.concatenate(ts + [np.zeros(16, np.uint8)])
    if rev:
        qs = [x[::-1].copy() for x in qs]
        ts = [x[::-1].copy() for x in ts]
    return qpool, tpool, jobs, qs, ts, js


def mutate_rates(rng: np.random.Generator, t: np.ndarray, sub: float,
                 ind: float) -> np.ndarray:
    """A copy of t with substitutions at rate sub and 1-base insertions and
    deletions at rate ind/2 each (an insertion goes before its base)."""
    r = rng.random(len(t))
    out = np.where(r >= 1 - sub, (t + rng.integers(1, 4, len(t))) % 4, t)
    ins = np.flatnonzero((r >= ind / 2) & (r < ind))
    out = np.insert(out, ins, rng.integers(0, 4, len(ins)))
    dele = np.flatnonzero(r < ind / 2)
    dele = dele + np.searchsorted(ins, dele, side="right")
    return np.delete(out, dele).astype(np.uint8)


class OnDevice:
    """One job batch's tensors on a device, laid out as DevCallPooled lays
    them out, with each kernel and its plain version on them.  gaps is
    (q, e, q2, e2): the DP kernel is extz when q == q2 and e == e2, else
    extd; with splice = (noncan, junc_bonus) it is (q, e, q2) and the DP
    kernel is exts, with the optional per-job junction bytes juncs."""

    def __init__(self, device, qpool, tpool, jobs, mat, gaps, flag: int,
                 end_bonus, splice=None, juncs=None):
        dev = torch.device(device)
        self.flag = flag
        self.mat, self.gaps, self.splice = mat, tuple(gaps), splice
        self.spliced = splice is not None
        self.min_intron = 0
        if self.spliced:
            self.dp_name = "exts"
            self.prof = K.exts_profile(mat, *gaps, *splice)
            self.min_intron = self.prof.min_intron
        elif gaps[0] == gaps[2] and gaps[1] == gaps[3]:
            self.dp_name = "extz"
            self.prof = K.extz_profile(mat, *gaps[:2])
        else:
            self.dp_name = "extd"
            self.prof = K.extd_profile(mat, *gaps)
        self.geo = K.job_geometry(jobs, unbanded=self.spliced)
        # K3's launch (exts_geometry); a test may set another
        self.k3 = K.exts_geometry(self.geo.cap, self.geo.qlen_max)
        ja = jobs.copy()
        ja[:, 6] = self.geo.w_eff
        self.jobs_np = ja
        self.qpool = torch.from_numpy(qpool).to(dev)
        self.tpool = torch.from_numpy(tpool).to(dev)
        self.jobs = torch.from_numpy(ja).to(dev)
        self.off = torch.from_numpy(self.geo.dirs_off).to(dev)
        self.ncol = torch.from_numpy(self.geo.ncol).to(dev)
        self.eb_np = np.broadcast_to(np.asarray(end_bonus, np.int64),
                                     (len(jobs),)).copy()
        self.eb = torch.from_numpy(self.eb_np).to(dev)
        self.n_ops = max(4, (int(self.geo.rows.max()) + 3) // 4 * 4)
        self.juncs = [None] * len(jobs) if juncs is None else juncs
        self.jpool, self.joff = K.junction_pool(juncs, dev)

    def k1(self):
        """The DP kernel: K1 (extd), K3 (exts) or K4 (extz)."""
        if self.spliced:
            return K.exts_dp(self.qpool, self.tpool, self.jobs, self.off,
                             self.ncol, self.k3, self.prof, self.flag,
                             self.geo.dirs_bytes, self.jpool, self.joff)
        fn = K.extz_dp if self.dp_name == "extz" else K.extd_dp
        return fn(self.qpool, self.tpool, self.jobs, self.off, self.ncol,
                  self.geo.cap, self.prof, self.flag, self.geo.dirs_bytes)

    def k1_plain(self):
        B = self.jobs.shape[0]
        res = torch.zeros((B, 16), dtype=torch.int32, device=self.jobs.device)
        dirs = torch.zeros(max(1, self.geo.dirs_bytes), dtype=torch.uint8,
                           device=self.jobs.device)
        if self.spliced:
            K.exts_dp_plain(self.qpool, self.tpool, self.jobs, self.off,
                            self.ncol, self.prof, self.flag, res, dirs,
                            self.jpool, self.joff)
        else:
            fn = (K.extz_dp_plain if self.dp_name == "extz"
                  else K.extd_dp_plain)
            fn(self.qpool, self.tpool, self.jobs, self.off, self.ncol,
               self.prof, self.flag, res, dirs)
        return res, dirs

    def starts(self, res):
        return K.select_starts(res, self.jobs, self.eb,
                               bool(self.flag & K.EZ_EXTZ_ONLY),
                               self.prof.dead, self.spliced)

    def k2(self, dirs, start):
        return K.traceback(dirs, self.off, self.jobs, self.ncol, start,
                           self.n_ops, self.min_intron)

    def k2_plain(self, dirs, start):
        B = self.jobs.shape[0]
        ops = torch.empty((B, self.n_ops), dtype=torch.uint8,
                          device=dirs.device)
        fin = torch.empty((B, 2), dtype=torch.int32, device=dirs.device)
        K.traceback_plain(dirs, self.off, self.jobs, self.ncol, start, ops,
                          fin, self.min_intron)
        return ops, fin

    def cigars(self, native, ops, fin):
        """Per-job CIGARs (BAM uint32 arrays) of a traceback's ops and
        remaining (i, j), decoded as DevCallPooled decodes them."""
        f = fin.cpu().numpy()
        rev = np.full(len(f), bool(self.flag & K.EZ_REV_CIGAR), np.uint8)
        if self.spliced:
            blob, off, ln = native.rle_ops_blob4(
                K.pack_ops4(ops).cpu().numpy(), f[:, 0], f[:, 1], rev,
                self.min_intron)
        else:
            blob, off, ln = native.rle_ops_blob(
                K.pack_ops(ops).cpu().numpy(), f[:, 0], f[:, 1], rev)
        return [blob[o:o + n] for o, n in zip(off, ln)]

    def native(self, native, i: int, qseq, tseq):
        """The native oracle (native.extd, native.extz or native.exts) on
        job i, whose query and target are given as the DP reads them."""
        jb = self.jobs_np[i]
        if self.spliced:
            return native.exts(qseq, tseq, self.mat, *self.gaps,
                               self.splice[0], int(jb[7]), self.splice[1],
                               self.flag, junc=self.juncs[i])
        w, zd, eb = int(jb[6]), int(jb[7]), int(self.eb_np[i])
        if self.dp_name == "extz":
            return native.extz(qseq, tseq, self.mat, *self.gaps[:2], w, zd,
                               eb, self.flag)
        return native.extd(qseq, tseq, self.mat, *self.gaps, w, zd, eb,
                           self.flag)


def _max_abs(a, b) -> int:
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def check_against_plain(c: OnDevice):
    """The DP kernel (K1, or K3 for a spliced batch) and K2 against their
    plain versions on every job of c.

    The DP kernel runs once and K2 twice: on the kernel's direction bytes
    and on the plain version's.  err[c.dp_name] is the largest absolute
    difference of the DP kernel's nine result fields from the plain ones,
    and of the traceback of its direction bytes (ops and remaining (i, j))
    from the plain traceback of the plain bytes, so each job's direction
    bytes along its path are held to the plain version.  err["traceback"]
    is that of K2 from the plain K2 on the same (plain) bytes.  Returns
    (err, res, ops, fin) of the kernel chain; ops and fin are None for
    score-only calls."""
    dp = c.dp_name
    res_k, dirs_k = c.k1()
    res_p, dirs_p = c.k1_plain()
    err = {dp: _max_abs(res_k[:, :9], res_p[:, :9]), "traceback": 0}
    if c.flag & K.EZ_SCORE_ONLY:
        return err, res_k, None, None
    ops_k, fin_k = c.k2(dirs_k, c.starts(res_k))
    start_p = c.starts(res_p)
    ops_kp, fin_kp = c.k2(dirs_p, start_p)
    ops_p, fin_p = c.k2_plain(dirs_p, start_p)
    err[dp] = max(err[dp], _max_abs(ops_k, ops_p), _max_abs(fin_k, fin_p))
    err["traceback"] = max(_max_abs(ops_kp, ops_p), _max_abs(fin_kp, fin_p))
    return err, res_k, ops_k, fin_k
