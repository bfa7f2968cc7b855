"""Each probe kernel against its plain version on the same device tensors.

Shared by chip_smoke.py (phase 7) and tests/test_torch_gpu.py.  The probes
are integer code, so every comparison is exact: the errors returned are 0
when the kernels are right.  Compared are res, the final state and the
dirs where the probe defines them (P3 from level 3 on, P1 under
dirs_store).  Two sets of cases: every probe case at a small shape, and
every case at the shape its entry point times it at (P3 with a few jobs
and its depth cut, so that the plain version stays cheap).
"""
from __future__ import annotations

import numpy as np
import torch

from . import probe_bisect as P1
from . import probe_core as P3
from . import probe_l0 as P2

SEED = 20261016
# the small shape of the checks
B, WB, ROWS, KR = 16, 128, 32, 3
# P3 at the timed Wb and ROWS: CORE_B jobs and about CORE_ROWS rows
CORE_B, CORE_ROWS = 8, 320
# the timed shapes' defaults: run_level's, probe_l0.run's, probe_bisect.run's
TIMED_B, TIMED_WB, TIMED_ROWS = 512, 640, 32
TIMED_KR = {"core": 63, "l0": 63, "bisect": 16}


def _err(a, b) -> int:
    if a is None and b is None:
        return 0
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def small_inputs(dev, B=B, Wb=WB, ROWS=ROWS, KR=KR, seed=SEED):
    """Random qbuf (bases 0-3, so the level-6 score matches a quarter of
    the time) and qlen (1 .. KR*ROWS + 15, so bands end inside the run);
    job 0 has qlen 1, whose walk sets done within ~100 rows from level 4
    on, and the last B // 2 jobs get the timed inputs (qbuf zeros, qlen
    1000)."""
    rng = np.random.default_rng(seed)
    qbuf = rng.integers(0, 4, (B, Wb + 384)).astype(np.uint8)
    qlen = rng.integers(1, KR * ROWS + 16, (B, 1)).astype(np.int32)
    qlen[0] = 1
    qbuf[B - B // 2:] = 0
    qlen[B - B // 2:] = 1000
    return torch.from_numpy(qbuf).to(dev), torch.from_numpy(qlen).to(dev)


def core_cases():
    """(level, dirs_mode, s32): levels 0-6 under every dirs mode, and the
    int32 state at level 6."""
    return [(lv, dm, False) for lv in range(7) for dm in P3.DIRS_MODES] + [
        (6, "u8", True)]


def timed_core_cases():
    """(name, level, dirs_mode, s32, ROWS) of every level of the ladder
    and every variant, as run_level times them."""
    kws = [(f"L{lv}", dict(level=lv)) for lv in P3.levels]
    kws += [(name.strip(), kv) for name, kv in P3.variants]
    return [(name, kv["level"], kv.get("dirs_mode", "u8"),
             kv.get("s32", False), kv.get("ROWS", TIMED_ROWS))
            for name, kv in kws]


def check_core(qbuf, qlen, level, dirs_mode, s32, Wb=WB, ROWS=ROWS,
               KR=KR) -> int:
    kw = dict(Wb=Wb, ROWS=ROWS, KR=KR, dirs_mode=dirs_mode, s32=s32)
    ck = torch.zeros((qbuf.shape[0], 2), dtype=torch.int64,
                     device=qbuf.device)
    cp = torch.zeros_like(ck)
    res, dirs, st = P3.core_probe(level, qbuf, qlen, work=ck, **kw)
    res_p, dirs_p, st_p = P3.core_plain(level, qbuf, qlen, work=cp, **kw)
    err = max(_err(res, res_p), _err(st, st_p), _err(ck, cp))
    if level >= 3:
        err = max(err, _err(dirs, dirs_p))
    return err


def check_timed_core(dev, level, dirs_mode, s32, ROWS) -> int:
    """One P3 case at the timed Wb and ROWS, CORE_B jobs, KR cut to about
    CORE_ROWS rows."""
    KR = max(1, CORE_ROWS // ROWS)
    qbuf, qlen = small_inputs(dev, B=CORE_B, Wb=TIMED_WB, ROWS=ROWS, KR=KR)
    return check_core(qbuf, qlen, level, dirs_mode, s32, Wb=TIMED_WB,
                      ROWS=ROWS, KR=KR)


def check_l0(qlen, kv, Wb=WB, KR=KR) -> int:
    kw = dict(nstate=kv.get("nstate", 7), Wb=Wb, KR=KR,
              touch=kv.get("touch", True), read_acc=kv.get("read_acc", True))
    res, st = P2.l0_probe(qlen, **kw)
    res_p, st_p = P2.l0_plain(qlen, **kw)
    return max(_err(res, res_p), _err(st, st_p))


def check_bisect(qlen, body, kv, Wb=WB, ROWS=ROWS, KR=KR) -> int:
    kw = dict(Wb=Wb, ROWS=ROWS, KR=KR, with_dirs=kv.get("with_dirs", True))
    res, dirs, st = P1.bisect_probe(body, qlen, **kw)
    res_p, dirs_p, st_p = P1.bisect_plain(body, qlen, **kw)
    err = max(_err(res, res_p), _err(st, st_p))
    if body is P1.dirs_store:
        err = max(err, _err(dirs, dirs_p))
    return err


def timed_qlen(dev):
    return torch.full((TIMED_B, 1), 1000, dtype=torch.int32, device=dev)


def check_timed_l0(dev, kv) -> int:
    """One P2 case at the shape run() times it at."""
    return check_l0(timed_qlen(dev), kv, Wb=TIMED_WB,
                    KR=kv.get("KR", TIMED_KR["l0"]))


def check_timed_bisect(dev, body, kv) -> int:
    """One P1 body at the shape run() times it at."""
    return check_bisect(timed_qlen(dev), body, kv, Wb=TIMED_WB,
                        ROWS=TIMED_ROWS, KR=TIMED_KR["bisect"])


def check_all(dev) -> dict:
    """Every P3 case, every P2 case and every P1 body at the small shape;
    returns the largest error per probe."""
    qbuf, qlen = small_inputs(dev)
    return {
        "probe_core": max(check_core(qbuf, qlen, *c) for c in core_cases()),
        "probe_l0": max(check_l0(qlen, kv) for _, kv in P2.cases),
        "probe_bisect": max(check_bisect(qlen, body, kv)
                            for _, body, kv in P1.variants),
    }


def check_timed(dev) -> dict:
    """Every P3 level and variant at its timed Wb and ROWS (a few jobs, the
    depth cut), every P2 case and every P1 body at its timed shape;
    returns the largest error per probe."""
    return {
        "probe_core": max(check_timed_core(dev, *c[1:])
                          for c in timed_core_cases()),
        "probe_l0": max(check_timed_l0(dev, kv) for _, kv in P2.cases),
        "probe_bisect": max(check_timed_bisect(dev, body, kv)
                            for _, body, kv in P1.variants),
    }
