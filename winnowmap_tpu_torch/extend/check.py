"""Random extd job batches, and K1/K2 held against their plain versions on
the same device tensors.

Shared by the on-card tests (tests/test_torch_gpu.py) and chip_smoke.py.
Both kernels are integer DP, so every comparison is exact: the errors that
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


class OnDevice:
    """One job batch's tensors on a device, laid out as DevCallPooled lays
    them out, with each kernel and its plain version on them."""

    def __init__(self, device, qpool, tpool, jobs, mat, gaps, flag: int,
                 end_bonus):
        dev = torch.device(device)
        self.flag = flag
        self.prof = K.extd_profile(mat, *gaps)
        self.geo = K.job_geometry(jobs)
        ja = jobs.copy()
        ja[:, 6] = self.geo.w_eff
        self.jobs_np = ja
        self.qpool = torch.from_numpy(qpool).to(dev)
        self.tpool = torch.from_numpy(tpool).to(dev)
        self.jobs = torch.from_numpy(ja).to(dev)
        self.off = torch.from_numpy(self.geo.dirs_off).to(dev)
        self.ncol = torch.from_numpy(self.geo.ncol).to(dev)
        self.eb = torch.from_numpy(
            np.broadcast_to(np.asarray(end_bonus, np.int64),
                            (len(jobs),)).copy()).to(dev)
        self.n_ops = max(4, (int(self.geo.rows.max()) + 3) // 4 * 4)

    def k1(self):
        return K.extd_dp(self.qpool, self.tpool, self.jobs, self.off,
                         self.ncol, self.geo.cap, self.prof, self.flag,
                         self.geo.dirs_bytes)

    def k1_plain(self):
        B = self.jobs.shape[0]
        res = torch.zeros((B, 16), dtype=torch.int32, device=self.jobs.device)
        dirs = torch.zeros(max(1, self.geo.dirs_bytes), dtype=torch.uint8,
                           device=self.jobs.device)
        K.extd_dp_plain(self.qpool, self.tpool, self.jobs, self.off,
                        self.ncol, self.prof, self.flag, res, dirs)
        return res, dirs

    def starts(self, res):
        return K.select_starts(res, self.jobs, self.eb,
                               bool(self.flag & K.EZ_EXTZ_ONLY),
                               self.prof.dead)

    def k2(self, dirs, start):
        return K.traceback(dirs, self.off, self.jobs, self.ncol, start,
                           self.n_ops)

    def k2_plain(self, dirs, start):
        B = self.jobs.shape[0]
        ops = torch.empty((B, self.n_ops), dtype=torch.uint8,
                          device=dirs.device)
        fin = torch.empty((B, 2), dtype=torch.int32, device=dirs.device)
        K.traceback_plain(dirs, self.off, self.jobs, self.ncol, start, ops,
                          fin)
        return ops, fin


def _max_abs(a, b) -> int:
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def check_against_plain(c: OnDevice):
    """K1 and K2 against their plain versions on every job of c.

    K1 runs once and K2 twice: on K1's direction bytes and on the plain
    K1's.  err["extd"] is the largest absolute difference of K1's nine
    result fields from the plain ones, and of the traceback of K1's
    direction bytes (ops and remaining (i, j)) from the plain traceback of
    the plain bytes, so each job's direction bytes along its path are held
    to the plain version.  err["traceback"] is that of K2 from the plain K2
    on the same (plain) bytes.  Returns (err, res, ops, fin) of the kernel
    chain; ops and fin are None for score-only calls."""
    res_k, dirs_k = c.k1()
    res_p, dirs_p = c.k1_plain()
    err = {"extd": _max_abs(res_k[:, :9], res_p[:, :9]), "traceback": 0}
    if c.flag & K.EZ_SCORE_ONLY:
        return err, res_k, None, None
    ops_k, fin_k = c.k2(dirs_k, c.starts(res_k))
    start_p = c.starts(res_p)
    ops_kp, fin_kp = c.k2(dirs_p, start_p)
    ops_p, fin_p = c.k2_plain(dirs_p, start_p)
    err["extd"] = max(err["extd"], _max_abs(ops_k, ops_p),
                      _max_abs(fin_k, fin_p))
    err["traceback"] = max(_max_abs(ops_kp, ops_p), _max_abs(fin_kp, fin_p))
    return err, res_k, ops_k, fin_k
