"""The port's spliced extension DP (extend/kernels.DevCallPooled with
splice=..., on the CPU: the plain PyTorch versions of the exts kernel and of
the spliced traceback) against the JAX package: its native oracle
(winnowmap_tpu.native.exts) on the cases of tests/test_pallas_cpu.py, and
its Pallas DevCallPooled in interpreter mode on two small jobs.  Integer
DP: the tolerance is 0 -- the 9 result fields and every CIGAR must be
equal.  Also the engine's placement of long jobs on the device and the
profile-based kernel choice."""
import os
import subprocess
import sys
import textwrap
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import winnowmap_tpu.native as jnative
from winnowmap_tpu.map.align import gen_simple_mat as jax_mat
from winnowmap_tpu_torch.extend import kernels as K
from winnowmap_tpu_torch.index.build import MinimizerIndex
from winnowmap_tpu_torch.map.align import gen_simple_mat

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
Q, E, Q2, NONCAN, JB = 2, 1, 32, 9, 9
# exact / approx+drop / rev-strand+flank / left-extension / both strands /
# score-only (tests/test_pallas_cpu.py), and a splice profile's job whose
# flag carries no splice bits
FLAGS = (0x100, 0x100 | 0x18, 0x200 | 0x400, 0x100 | 0x40 | 0x02 | 0x80,
         0x300, 0x100 | 0x01, 0x00)


def _cases():
    """The intron and non-intron pairs of test_pallas_cpu.py, junction
    bytes on the non-intron ones: [(query, target, junc | None)]."""
    rng = np.random.default_rng(11)

    def mutate(t, err):
        t = t.copy()
        m = rng.random(len(t)) < err
        t[m] = (t[m] + rng.integers(1, 4, m.sum())) % 4
        return t

    cases = []
    for seed in range(4):
        r2 = np.random.default_rng(seed)
        qlen = int(r2.integers(30, 90))
        qsq = r2.integers(0, 4, qlen).astype(np.uint8)
        if seed % 2 == 0:
            half = qlen // 2
            intron = r2.integers(0, 4, 40).astype(np.uint8)
            intron[0], intron[1] = 2, 3  # GT donor
            intron[-2], intron[-1] = 0, 2  # AG acceptor
            tsq = np.concatenate([mutate(qsq[:half], 0.05), intron,
                                  mutate(qsq[half:], 0.05)]).astype(np.uint8)
        else:
            tsq = r2.integers(0, 4, int(r2.integers(30, 150))).astype(
                np.uint8)
        jl = None
        if seed % 2 == 1:
            jl = ((r2.random(len(tsq)) < 0.05).astype(np.uint8)
                  * r2.integers(1, 16, len(tsq)).astype(np.uint8))
        cases.append((qsq, tsq, jl))
    return cases


def _pooled(cases, rev):
    """Pools and (B, 8) job rows that present each case to the DP as given;
    with rev, some jobs read their query or target reversed from the pool
    (the pool holds it reversed), as the engine's left extensions do."""
    B = len(cases)
    qrev = (np.arange(B) % 2 == 1) if rev else np.zeros(B, bool)
    trev = (np.arange(B) % 3 == 2) if rev else np.zeros(B, bool)
    qs = [c[0][::-1] if r else c[0] for c, r in zip(cases, qrev)]
    ts = [c[1][::-1] if r else c[1] for c, r in zip(cases, trev)]
    qpool = np.concatenate(qs + [np.zeros(8, np.uint8)])
    tpool = np.concatenate(ts + [np.zeros(8, np.uint8)])
    jobs = np.zeros((B, 8), np.int64)
    jobs[:, 0] = np.cumsum([0] + [len(x) for x in qs])[:-1]
    jobs[:, 1] = [len(x) for x in qs]
    jobs[:, 2] = qrev
    jobs[:, 3] = np.cumsum([0] + [len(x) for x in ts])[:-1]
    jobs[:, 4] = [len(x) for x in ts]
    jobs[:, 5] = trev
    jobs[:, 6] = 7  # exts is unbanded: w is ignored
    return qpool, tpool, jobs


def _run_port(qpool, tpool, jobs, flag, juncs=None, splice=(NONCAN, JB)):
    mi = MinimizerIndex(w=10, k=15, codes=tpool)
    pools = K.PoolContext(qpool, mi, torch.device("cpu"))
    return K.DevCallPooled(pools, jobs, gen_simple_mat(1, 2, 1), Q, E, Q2, 0,
                           0, flag, splice=splice, juncs=juncs).collect_blob()


def _fields(h):
    return [h.max, int(h.zdropped), h.max_q, h.max_t, h.mqe, h.mqe_t, h.mte,
            h.mte_q, h.score]


@pytest.mark.parametrize("rev", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("flag", FLAGS, ids=lambda f: f"flag{f:#05x}")
def test_pooled_exts_matches_native_exts(flag, rev):
    cases = _cases()
    qpool, tpool, jobs = _pooled(cases, rev)
    zd = 100 if flag & 0x10 else 200
    jobs[:, 7] = zd
    res9, blob, off, ln, reach = _run_port(qpool, tpool, jobs, flag,
                                           juncs=[c[2] for c in cases])
    assert not reach.any()
    n_intron = 0
    for i, (qsq, tsq, jl) in enumerate(cases):
        h = jnative.exts(qsq, tsq, jax_mat(1, 2, 1), Q, E, Q2, NONCAN, zd,
                         JB, flag, junc=jl)
        assert res9[i].tolist() == _fields(h), (hex(flag), i)
        if not flag & 0x01:
            assert np.array_equal(blob[off[i]:off[i] + ln[i]], h.cigar), \
                (hex(flag), i)
            n_intron += int(((h.cigar & 15) == 3).any())
    if flag & 0x300 and not flag & (0x01 | 0x80):
        # the intron cases splice (their motifs read forward)
        assert n_intron > 0


def test_splice_profile_flag_zero_runs_exts():
    """A splice-profile job whose flag has no splice bits still runs
    wm_exts (all-zero site scores), not wm_extd: the engine picks the
    kernel from the profile (MapEngine._dispatch)."""
    from winnowmap_tpu_torch.map.engine import MapEngine
    from winnowmap_tpu_torch.options import MapOptions, set_preset

    cases = _cases()
    qpool, tpool, jobs = _pooled(cases, rev=False)
    jobs[:, 7] = 200
    mo = MapOptions()
    set_preset("splice", _IdxOpts(), mo)
    eng = object.__new__(MapEngine)
    eng.opts3 = [mo] * 3
    eng.pools = K.PoolContext(qpool, MinimizerIndex(w=10, k=15, codes=tpool),
                              torch.device("cpu"))
    rows = np.zeros((len(jobs), 12), np.int64)
    rows[:, 0] = np.arange(len(jobs))
    rows[:, 1:9] = jobs
    (call, crows), = eng._dispatch(0, 0x00, rows)
    res9, blob, off, ln, _ = call.collect_blob()
    mat = jax_mat(mo.a, mo.b, mo.sc_ambi)
    n_differ = 0
    for k, i in enumerate(crows[:, 0]):
        qsq, tsq, _ = cases[i]
        h = jnative.exts(qsq, tsq, mat, mo.q, mo.e, mo.q2, mo.noncan, 200,
                         mo.junc_bonus, 0x00)
        assert res9[k].tolist() == _fields(h), i
        assert np.array_equal(blob[off[k]:off[k] + ln[k]], h.cigar), i
        d = jnative.extd(qsq, tsq, mat, mo.q, mo.e, mo.q2, mo.e2, 7, 200, 0,
                         0x00)
        n_differ += _fields(d) != _fields(h)
    assert n_differ > 0  # extd would have given other results


class _IdxOpts:
    """Stand-in for IndexOptions where only the map options matter."""

    flag = k = w = 0


@pytest.mark.parametrize("preset,min_intron",
                         [("splice", 29), ("splice:hq", 17), ("cdna", 29)])
def test_exts_profile_min_intron(preset, min_intron):
    from winnowmap_tpu_torch.options import MapOptions, set_preset

    mo = MapOptions()
    set_preset(preset, _IdxOpts(), mo)
    prof = K.exts_profile(gen_simple_mat(mo.a, mo.b, mo.sc_ambi), mo.q, mo.e,
                          mo.q2, mo.noncan, mo.junc_bonus)
    assert prof.min_intron == prof.long_thres == min_intron
    assert prof.sc_n == -mo.sc_ambi and prof.e2 == 0 and not prof.dead
    # wm_exts's refusal: q2 <= q + e
    assert K.exts_profile(gen_simple_mat(1, 2, 1), 2, 1, 3, 9, 9).dead


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
        pools, d['jobs'], gen_simple_mat(1, 2, 1), 2, 1, 32, 0, 0,
        int(d['flag']), TB=8, splice=(9, 9)).collect_blob()
    np.savez({out!r}, res9=res9, blob=blob, off=off, ln=ln, reach=reach)
    print('JAX-EXTS-OK')
""")


def test_pooled_exts_matches_jax_devcallpooled_interpret(tmp_path):
    """collect_blob of the port's spliced call equals the JAX
    DevCallPooled(splice=(9, 9))'s (Pallas kernels in interpreter mode, run
    as tests/test_pallas_cpu.py runs them) on an intron pair and a
    non-intron pair."""
    cases = _cases()[:2]
    qpool, tpool, jobs = _pooled(cases, rev=False)
    jobs[:, 7] = 200
    flag = 0x100 | 0x400
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, qpool=qpool, tpool=tpool, jobs=jobs, flag=flag)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT.format(repo=str(REPO),
                                                 inp=str(inp), out=str(out))],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "JAX-EXTS-OK" in proc.stdout
    ref = np.load(out)
    res9, blob, off, ln, reach = _run_port(qpool, tpool, jobs, flag)
    assert np.array_equal(res9, ref["res9"])
    assert np.array_equal(reach, ref["reach"])
    assert np.array_equal(ln, ref["ln"])
    for i in range(len(cases)):
        assert np.array_equal(blob[off[i]:off[i] + ln[i]],
                              ref["blob"][ref["off"][i]:ref["off"][i]
                                          + ref["ln"][i]])
    assert ((blob & 15) == 3).any()  # the intron pair's N op


def _long_tail_read(seed, keep, tail):
    """A 30 kb genome and one read: `keep` bases of it, then a random tail,
    so the read's right extension is a job with a long query and target."""
    rng = np.random.default_rng(seed)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 30000))
    read = g[5000:5000 + keep] + "".join(
        "ACGT"[i] for i in rng.integers(0, 4, tail))
    return g, read


# scorings that pushed such jobs past the TPU kernel's score-range bounds
# (wm_engine.cpp device_eligible before the port dropped them): extd with
# e = 30 and both sides above 2048; exts with q + 2e = 81 and a query above
# 1536
LONG_JOBS = {
    "extd": ("map-ont", dict(q=1, e=30, q2=60, e2=1), 2000, 2600, 2048),
    "exts": ("splice", dict(q=1, e=40, q2=85), 2000, 1700, 1536),
}


@pytest.mark.parametrize("kind", sorted(LONG_JOBS))
def test_long_jobs_leave_the_engine(kind, tmp_path, monkeypatch):
    """Jobs past the TPU kernel's limits are exported to the device path
    (none stays on the engine's host DP), and the results equal the JAX
    package's engine on its host kernels."""
    from winnowmap_tpu.index.build import build_index as jbuild
    from winnowmap_tpu.io.fastx import read_all as jread
    from winnowmap_tpu.map.engine import map_batch_engine as jmap
    from winnowmap_tpu.options import IndexOptions as JIo
    from winnowmap_tpu.options import MapOptions as JMo
    from winnowmap_tpu.options import set_preset as jpreset
    from winnowmap_tpu.options import update_mid_occ as jmid
    from winnowmap_tpu_torch.index.build import build_index
    from winnowmap_tpu_torch.io.fastx import read_all
    from winnowmap_tpu_torch.map import engine
    from winnowmap_tpu_torch.map.batch import STATS, map_batch
    from winnowmap_tpu_torch.options import MM_F_CIGAR, IndexOptions
    from winnowmap_tpu_torch.options import MapOptions, set_preset
    from winnowmap_tpu_torch.options import update_mid_occ
    from test_torch_engine import assert_same_results

    preset, gaps, keep, tail, side = LONG_JOBS[kind]
    g, read = _long_tail_read(7, keep, tail)
    ref_fa = tmp_path / "ref.fa"
    ref_fa.write_text(f">chr1\n{g}\n")
    seqs, names = [read.encode()], ["r"]

    io_, mo = IndexOptions(), MapOptions()
    set_preset(preset, io_, mo)
    mo = replace(mo, flag=mo.flag | MM_F_CIGAR, sv_aware=False, **gaps)
    mi = build_index(read_all(str(ref_fa)), io_.w, io_.k, io_.flag,
                     np.zeros(0, np.uint64))
    update_mid_occ(mo, mi)
    seen = []

    class Recording(K.DevCallPooled):
        def __init__(self, pools, jobs, *a, **kw):
            seen.append(np.array(jobs))
            super().__init__(pools, jobs, *a, **kw)

    monkeypatch.setattr(engine, "DevCallPooled", Recording)
    STATS.clear()
    got = map_batch(mi, mo, seqs, names, device="cpu")
    jobs = np.concatenate(seen)
    assert STATS["eng_host_dp_calls"] == 0
    assert STATS["delivered_jobs"] == STATS["dev_jobs"] == len(jobs)
    assert ((jobs[:, 1] > side) & (jobs[:, 4] > side)).any()

    monkeypatch.setenv("WM_NO_TPU", "1")
    jio, jmo = JIo(), JMo()
    jpreset(preset, jio, jmo)
    jmo = replace(jmo, flag=jmo.flag | MM_F_CIGAR, sv_aware=False, **gaps)
    jmi = jbuild(jread(str(ref_fa)), jio.w, jio.k, jio.flag,
                 np.zeros(0, np.uint64))
    jmid(jmo, jmi)
    assert_same_results(jmap(jmi, jmo, seqs, names), got)
    assert got[0].regs and got[0].regs[0].p is not None
