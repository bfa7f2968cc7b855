"""The port's extension DP (extend/kernels.DevCallPooled on the CPU, i.e.
the plain PyTorch versions of the extd and traceback kernels) against the
JAX package: its native oracle (winnowmap_tpu.native.extd) on the cases of
tests/test_pallas_cpu.py, and its Pallas DevCallPooled in interpreter mode
on one small case.  Integer DP: the tolerance is 0 -- the 9 result fields,
the reach flag and every CIGAR must be equal."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import winnowmap_tpu.native as jnative
from winnowmap_tpu.map.align import gen_simple_mat as jax_mat
from winnowmap_tpu_torch.extend import check
from winnowmap_tpu_torch.extend import kernels as K
from winnowmap_tpu_torch.index.build import MinimizerIndex
from winnowmap_tpu_torch.map.align import gen_simple_mat

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# map-ont and asm5 (a, b, q, e, q2, e2): asm5's q2=81 drives int8 wraps
PROFILES = {"map-ont": (2, 4, 4, 2, 24, 1), "asm5": (1, 19, 39, 3, 81, 1)}
FLAGS = (0x08 | 0x10, 0x0, 0x42 | 0x80, 0x40, 0x01)


def _cases():
    """The mutated pairs and the dissimilar pair of test_pallas_cpu.py."""
    rng = np.random.default_rng(3)

    def mutate(q, sub, ind):
        out = []
        i = 0
        while i < len(q):
            r = rng.random()
            if r < ind / 2:
                i += 1
                continue
            if r < ind:
                out.append(rng.integers(0, 4))
                continue
            if r < ind + sub:
                out.append((q[i] + 1 + rng.integers(0, 3)) % 4)
            else:
                out.append(q[i])
            i += 1
        return np.array(out, dtype=np.uint8)

    qs, ts = [], []
    for _ in range(4):
        n = int(rng.integers(60, 120))
        t = rng.integers(0, 4, n).astype(np.uint8)
        qs.append(mutate(t, 0.08, 0.08))
        ts.append(t)
    qs.append(rng.integers(0, 4, 150).astype(np.uint8))
    ts.append(rng.integers(0, 4, 140).astype(np.uint8))
    return qs, ts


def _pooled(qs, ts, ws, zdrop, rev=True):
    """Pools + (B, 8) job rows; with rev, some jobs read their query or
    target reversed from the pool (as the engine's left extensions do)."""
    qpool = np.concatenate(qs + [np.zeros(8, np.uint8)])
    tpool = np.concatenate(ts + [np.zeros(8, np.uint8)])
    qo = np.cumsum([0] + [len(x) for x in qs])[:-1]
    to = np.cumsum([0] + [len(x) for x in ts])[:-1]
    B = len(qs)
    jobs = np.zeros((B, 8), np.int64)
    jobs[:, 0], jobs[:, 1] = qo, [len(x) for x in qs]
    jobs[:, 3], jobs[:, 4] = to, [len(x) for x in ts]
    if rev:
        jobs[:, 2] = np.arange(B) % 2 == 1
        jobs[:, 5] = np.arange(B) % 3 == 2
    jobs[:, 6] = ws
    jobs[:, 7] = zdrop
    return qpool, tpool, jobs


def _run_port(qpool, tpool, jobs, prof, eb, flag):
    mi = MinimizerIndex(w=10, k=15, codes=tpool)
    pools = K.PoolContext(qpool, mi, torch.device("cpu"))
    a, b, q, e, q2, e2 = prof
    return K.DevCallPooled(pools, jobs, gen_simple_mat(a, b, 1), q, e, q2,
                           e2, eb, flag).collect_blob()


@pytest.mark.parametrize("flag", FLAGS, ids=lambda f: f"flag{f:#04x}")
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_pooled_matches_native_extd(profile, flag):
    qs, ts = _cases()
    ws = [97 if i % 2 == 0 else 64 for i in range(len(qs))]
    qpool, tpool, jobs = _pooled(qs, ts, ws, 200)
    eb = np.array([10, 0, 25, 5, 40])[:len(qs)]
    res9, blob, off, ln, reach = _run_port(qpool, tpool, jobs,
                                           PROFILES[profile], eb, flag)
    a, b, q, e, q2, e2 = PROFILES[profile]
    mat = jax_mat(a, b, 1)
    for i in range(len(qs)):
        qq = qs[i][::-1] if jobs[i, 2] else qs[i]
        tt = ts[i][::-1] if jobs[i, 5] else ts[i]
        h = jnative.extd(qq, tt, mat, q, e, q2, e2, ws[i], 200, int(eb[i]),
                         flag)
        assert res9[i].tolist() == [
            h.max, int(h.zdropped), h.max_q, h.max_t, h.mqe, h.mqe_t, h.mte,
            h.mte_q, h.score], (profile, flag, i)
        if not flag & 0x01:
            assert np.array_equal(blob[off[i]:off[i] + ln[i]], h.cigar), \
                (profile, flag, i)
            assert bool(reach[i]) == h.reach_end, (profile, flag, i)


@pytest.mark.parametrize("profile,flag", [("map-ont", 0x18), ("asm5", 0x0)])
def test_check_batches_match_native_extd(profile, flag):
    """The job batches that the on-card checks draw (extend/check.py) lay
    out each job as native.extd sees it, and check_against_plain reports
    no error when the kernel chain is the plain one (CPU tensors)."""
    rng = np.random.default_rng(17)
    qpool, tpool, jobs, qs, ts = check.random_jobs(
        rng, rng.integers(40, 200, 6), rng.choice([-1, 33, 97], 7), 200,
        dissimilar=True)
    a, b, q, e, q2, e2 = PROFILES[profile]
    eb = rng.integers(0, 60, 7)
    c = check.OnDevice("cpu", qpool, tpool, jobs, gen_simple_mat(a, b, 1),
                       (q, e, q2, e2), flag, eb)
    err, res, ops, fin = check.check_against_plain(c)
    assert err == {"extd": 0, "traceback": 0}
    packed = K.pack_ops(ops).numpy()
    f = fin.numpy()
    blob, off, ln = jnative.rle_ops_blob(packed, f[:, 0], f[:, 1],
                                         np.zeros(len(f), np.uint8))
    mat = jax_mat(a, b, 1)
    for i in range(len(qs)):
        qq = qs[i][::-1] if jobs[i, 2] else qs[i]
        tt = ts[i][::-1] if jobs[i, 5] else ts[i]
        h = jnative.extd(qq, tt, mat, q, e, q2, e2, int(jobs[i, 6]), 200,
                         int(eb[i]), flag)
        assert res[i, :9].tolist() == [
            h.max, int(h.zdropped), h.max_q, h.max_t, h.mqe, h.mqe_t, h.mte,
            h.mte_q, h.score], (profile, i)
        assert np.array_equal(blob[off[i]:off[i] + ln[i]], h.cigar), \
            (profile, i)


@pytest.mark.parametrize("profile,flag", [("asm5", 0x0), ("map-ont", 0x18)])
def test_ragged_banded_batch_matches_native_extd(profile, flag):
    """Mixed band widths in one call: lanes right of a narrow job's band
    stay at their initial state while a wider job sets the window (the
    plain version keeps the band state of all jobs in one tensor)."""
    rng = np.random.default_rng(23)
    lens = rng.integers(50, 400, 15)
    ws = rng.choice([64, 97, 500, 751, -1], 16)
    qpool, tpool, jobs, qs, ts = check.random_jobs(
        rng, lens, ws, rng.choice([40, 200, 400], 16), dissimilar=True)
    a, b, q, e, q2, e2 = PROFILES[profile]
    eb = rng.integers(0, 60, 16)
    c = check.OnDevice("cpu", qpool, tpool, jobs, gen_simple_mat(a, b, 1),
                       (q, e, q2, e2), flag, eb)
    res, dirs = c.k1_plain()
    ops, fin = c.k2_plain(dirs, c.starts(res))
    cig = c.cigars(jnative, ops, fin)
    mat = jax_mat(a, b, 1)
    for i in range(len(qs)):
        qq = qs[i][::-1] if jobs[i, 2] else qs[i]
        tt = ts[i][::-1] if jobs[i, 5] else ts[i]
        h = jnative.extd(qq, tt, mat, q, e, q2, e2, int(jobs[i, 6]),
                         int(jobs[i, 7]), int(eb[i]), flag)
        assert res[i, :9].tolist() == [
            h.max, int(h.zdropped), h.max_q, h.max_t, h.mqe, h.mqe_t, h.mte,
            h.mte_q, h.score], (profile, i)
        assert np.array_equal(cig[i], h.cigar), (profile, i)


def test_pooled_unported_profiles_raise():
    """Single-cost profiles (q == q2 and e == e2) run extz and equal
    native.extz; splice bits in the flag do not pick a kernel (the profile
    does, through DevCallPooled's splice argument), so without it the call
    runs extd."""
    qs, ts = _cases()
    qpool, tpool, jobs = _pooled(qs[:1], ts[:1], [64], 200)
    qq = qs[0][::-1] if jobs[0, 2] else qs[0]
    tt = ts[0][::-1] if jobs[0, 5] else ts[0]
    res9, blob, off, ln, _ = _run_port(qpool, tpool, jobs,
                                       (2, 4, 4, 2, 4, 2), 0, 0)
    h = jnative.extz(qq, tt, jax_mat(2, 4, 1), 4, 2, 64, 200, 0, 0)
    assert res9[0].tolist() == [h.max, int(h.zdropped), h.max_q, h.max_t,
                                h.mqe, h.mqe_t, h.mte, h.mte_q, h.score]
    assert np.array_equal(blob[off[0]:off[0] + ln[0]], h.cigar)
    res9, blob, off, ln, _ = _run_port(qpool, tpool, jobs,
                                       PROFILES["map-ont"], 0, 0x100)
    a, b, q, e, q2, e2 = PROFILES["map-ont"]
    h = jnative.extd(qq, tt, jax_mat(a, b, 1), q, e, q2, e2, 64, 200, 0,
                     0x100)
    assert res9[0].tolist() == [h.max, int(h.zdropped), h.max_q, h.max_t,
                                h.mqe, h.mqe_t, h.mte, h.mte_q, h.score]
    assert np.array_equal(blob[off[0]:off[0] + ln[0]], h.cigar)


JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ['JAX_PLATFORMS'] = 'cpu'
    os.environ['WM_PALLAS_INTERPRET'] = '1'
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import numpy as np
    import winnowmap_tpu.extend.pallas_kernel as PK
    PK.quantize_batch = lambda n: n
    PK.extd_rows = lambda Wb: 4
    from winnowmap_tpu.map.align import gen_simple_mat
    d = np.load({inp!r})
    pools = PK.PoolContext(d['qpool'], d['tpool'])
    res9, blob, off, ln, reach = PK.DevCallPooled(
        pools, d['jobs'], gen_simple_mat(2, 4, 1), 4, 2, 24, 1, d['eb'],
        int(d['flag']), TB=8).collect_blob()
    np.savez({out!r}, res9=res9, blob=blob, off=off, ln=ln, reach=reach)
    print('JAX-POOLED-OK')
""")


def test_pooled_matches_jax_devcallpooled_interpret(tmp_path):
    """collect_blob of the port equals the JAX DevCallPooled's (Pallas
    kernels in interpreter mode, run as tests/test_pallas_cpu.py runs
    them)."""
    qs, ts = _cases()
    qs, ts = qs[:2], ts[:2]
    qpool, tpool, jobs = _pooled(qs, ts, [64, 97], 200, rev=False)
    eb = np.array([10, 30])
    flag = 0x40
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, qpool=qpool, tpool=tpool, jobs=jobs, eb=eb, flag=flag)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT.format(repo=str(REPO),
                                                 inp=str(inp), out=str(out))],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "JAX-POOLED-OK" in proc.stdout
    ref = np.load(out)
    res9, blob, off, ln, reach = _run_port(qpool, tpool, jobs,
                                           PROFILES["map-ont"], eb, flag)
    assert np.array_equal(res9, ref["res9"])
    assert np.array_equal(reach, ref["reach"])
    assert np.array_equal(ln, ref["ln"])
    for i in range(len(qs)):
        assert np.array_equal(blob[off[i]:off[i] + ln[i]],
                              ref["blob"][ref["off"][i]:ref["off"][i]
                                          + ref["ln"][i]])
