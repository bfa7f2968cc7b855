"""The port's single-cost extension (extz, K4's plain PyTorch version on the
CPU) against the JAX package: its native oracle (winnowmap_tpu.native.extz)
job for job, its Pallas DevCallPooled in interpreter mode on one small case,
and its engine's regions on the golden reads; and the two engine repairs
that send every DP job to the device path (jobs with a side above 32768,
the inversion rescue).  Integer DP: the tolerance is 0 -- the 9 result
fields, the reach flag and every CIGAR must be equal."""
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
from winnowmap_tpu_torch.extend import check
from winnowmap_tpu_torch.extend import kernels as K
from winnowmap_tpu_torch.map.align import gen_simple_mat
from test_torch_engine import assert_same_results
from test_torch_extend import _cases, _pooled, _run_port

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# one gap cost (a, b, q, e, q2, e2): map-ont's q and e, and a profile whose
# biased score byte wraps (q + e = 63: max_sc = 2 + 126 = 128, where the
# signed and unsigned views of the state part).  The wrap profile's scores
# fall at once, so its jobs run without z-drop (-1) to fill the matrices.
PROFILES = {"single": (2, 4, 4, 2, 4, 2), "wrap": (2, 4, 61, 2, 61, 2)}
ZDROP = {"single": 200, "wrap": -1}
FLAGS = (0x08 | 0x10, 0x0, 0x42 | 0x80, 0x40, 0x01)


def _native_fields(h):
    return [h.max, int(h.zdropped), h.max_q, h.max_t, h.mqe, h.mqe_t, h.mte,
            h.mte_q, h.score]


def test_extz_profile():
    """DevCallPooled's extz scoring: sc_n = mat[24] or -e, max_sc = mat[0]
    + 2(q + e) as a byte, and wm_extz's refusal -min(mat[1:]) > 2(q + e)."""
    p = K.extz_profile(gen_simple_mat(2, 4, 1), 61, 2)
    assert (p.sc_mch, p.sc_mis, p.sc_n, p.max_sc, p.dead) == \
        (2, -4, -1, 128, False)
    p = K.extz_profile(gen_simple_mat(2, 4, 0), 4, 2)
    assert (p.sc_n, p.max_sc) == (-2, 14)
    assert K.extz_profile(gen_simple_mat(2, 13, 1), 4, 2).dead


@pytest.mark.parametrize("flag", FLAGS, ids=lambda f: f"flag{f:#04x}")
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_pooled_matches_native_extz(profile, flag):
    qs, ts = _cases()
    ws = [97 if i % 2 == 0 else 64 for i in range(len(qs))]
    qpool, tpool, jobs = _pooled(qs, ts, ws, ZDROP[profile])
    eb = np.array([10, 0, 25, 5, 40])[:len(qs)]
    res9, blob, off, ln, reach = _run_port(qpool, tpool, jobs,
                                           PROFILES[profile], eb, flag)
    a, b, q, e, _, _ = PROFILES[profile]
    mat = jax_mat(a, b, 1)
    if not flag & 0x41:  # every job reaches its end: a CIGAR each
        assert (ln > 0).all()
    for i in range(len(qs)):
        qq = qs[i][::-1] if jobs[i, 2] else qs[i]
        tt = ts[i][::-1] if jobs[i, 5] else ts[i]
        h = jnative.extz(qq, tt, mat, q, e, ws[i], ZDROP[profile],
                         int(eb[i]), flag)
        assert res9[i].tolist() == _native_fields(h), (profile, flag, i)
        if not flag & 0x01:
            assert np.array_equal(blob[off[i]:off[i] + ln[i]], h.cigar), \
                (profile, flag, i)
            assert bool(reach[i]) == h.reach_end, (profile, flag, i)


@pytest.mark.parametrize("profile,flag", [
    ("single", 0x18), ("single", 0x0), ("wrap", 0xC2), ("wrap", 0x40)],
    ids=lambda v: f"{v:#04x}" if isinstance(v, int) else v)
def test_ragged_banded_batch_matches_native_extz(profile, flag):
    """Mixed band widths in one call (w in {64, 97, 500, -1}), the on-card
    checks' batch builder (extend/check.py): check_against_plain reports no
    error when the kernel chain is the plain one (CPU tensors), and every
    job equals native.extz."""
    rng = np.random.default_rng(29)
    lens = rng.integers(50, 400, 11)
    ws = rng.choice([64, 97, 500, -1], 12)
    zdrops = rng.choice([40, 200, 400], 12) if profile == "single" else -1
    qpool, tpool, jobs, qs, ts = check.random_jobs(rng, lens, ws, zdrops,
                                                   dissimilar=True)
    a, b, q, e, q2, e2 = PROFILES[profile]
    c = check.OnDevice("cpu", qpool, tpool, jobs, gen_simple_mat(a, b, 1),
                       (q, e, q2, e2), flag, rng.integers(0, 60, 12))
    assert c.dp_name == "extz"
    err, res, ops, fin = check.check_against_plain(c)
    assert err == {"extz": 0, "traceback": 0}
    cig = c.cigars(jnative, ops, fin)
    for i in range(len(qs)):
        qq = qs[i][::-1] if jobs[i, 2] else qs[i]
        tt = ts[i][::-1] if jobs[i, 5] else ts[i]
        h = c.native(jnative, i, qq, tt)
        assert res[i, :9].tolist() == _native_fields(h), (profile, i)
        assert np.array_equal(cig[i], h.cigar), (profile, i)


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
    from winnowmap_tpu.map.align import gen_simple_mat
    d = np.load({inp!r})
    a, b, q, e = (int(x) for x in d['prof'])
    pools = PK.PoolContext(d['qpool'], d['tpool'])
    res9, blob, off, ln, reach = PK.DevCallPooled(
        pools, d['jobs'], gen_simple_mat(a, b, 1), q, e, q, e, d['eb'],
        int(d['flag']), TB=8).collect_blob()
    np.savez({out!r}, res9=res9, blob=blob, off=off, ln=ln, reach=reach)
    print('JAX-POOLED-OK')
""")


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_pooled_matches_jax_devcallpooled_interpret(profile, tmp_path):
    """collect_blob of the port equals the JAX DevCallPooled's on its extz
    route (q2 = q, e2 = e: the Pallas K4 in interpreter mode, run as
    tests/test_pallas_cpu.py runs its kernels), and both equal
    native.extz."""
    qs, ts = _cases()
    qs, ts = qs[:2], ts[:2]
    zdrop = ZDROP[profile]
    qpool, tpool, jobs = _pooled(qs, ts, [64, 97], zdrop, rev=False)
    eb = np.array([10, 30])
    flag = 0x40
    a, b, q, e, _, _ = PROFILES[profile]
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, qpool=qpool, tpool=tpool, jobs=jobs, eb=eb, flag=flag,
             prof=np.array([a, b, q, e]))
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
                                           PROFILES[profile], eb, flag)
    assert np.array_equal(res9, ref["res9"])
    assert np.array_equal(reach, ref["reach"])
    assert np.array_equal(ln, ref["ln"])
    for i in range(len(qs)):
        assert np.array_equal(blob[off[i]:off[i] + ln[i]],
                              ref["blob"][ref["off"][i]:ref["off"][i]
                                          + ref["ln"][i]])
        h = jnative.extz(qs[i], ts[i], jax_mat(a, b, 1), q, e,
                         int(jobs[i, 6]), zdrop, int(eb[i]), flag)
        assert res9[i].tolist() == _native_fields(h)
        assert np.array_equal(blob[off[i]:off[i] + ln[i]], h.cigar)


def test_map_batch_single_cost_matches_jax_engine(monkeypatch):
    """map_batch with -O 4,4 -E 2,2 on the first five golden reads,
    SV-aware: every region equals the JAX engine's (host kernels), and
    every DP job went through the port's extz path."""
    from test_torch_engine import jax_setup, port_setup
    from winnowmap_tpu.map.engine import map_batch_engine
    from winnowmap_tpu_torch.map.batch import STATS, map_batch

    monkeypatch.setenv("WM_NO_TPU", "1")
    jmi, jmo, seqs, names = jax_setup(True)
    seqs, names = seqs[:5], names[:5]
    ref = map_batch_engine(jmi, replace(jmo, q2=jmo.q, e2=jmo.e), seqs,
                           names)
    mi, mo = port_setup(True)
    STATS.clear()
    K.reset_launches()
    got = map_batch(mi, replace(mo, q2=mo.q, e2=mo.e), seqs, names,
                    device="cpu")
    assert_same_results(ref, got)
    assert STATS["delivered_jobs"] == STATS["dev_jobs"] > 0
    assert STATS["eng_host_dp_calls"] == 0
    assert sum(len(x.regs) for x in got) >= len(seqs)


def test_map_batch_wrap_profile_matches_jax_engine(monkeypatch):
    """map_batch under the wrap profile (-O 61,61 -E 2,2) on two golden
    reads: its DP jobs run through the port's extz path, and the regions
    equal the JAX engine's (the wrapped scores drop every alignment in
    both)."""
    from test_torch_engine import jax_setup, port_setup
    from winnowmap_tpu.map.engine import map_batch_engine
    from winnowmap_tpu_torch.map.batch import STATS, map_batch

    monkeypatch.setenv("WM_NO_TPU", "1")
    gaps = dict(q=61, q2=61, e=2, e2=2)
    jmi, jmo, seqs, names = jax_setup(True)
    seqs, names = seqs[:2], names[:2]
    ref = map_batch_engine(jmi, replace(jmo, **gaps), seqs, names)
    mi, mo = port_setup(True)
    STATS.clear()
    got = map_batch(mi, replace(mo, **gaps), seqs, names, device="cpu")
    assert_same_results(ref, got)
    assert STATS["delivered_jobs"] == STATS["dev_jobs"] > 0
    assert STATS["eng_host_dp_calls"] == 0


def _genome_and_index(rng, n):
    from winnowmap_tpu_torch.index.build import build_index
    from winnowmap_tpu_torch.io.fastx import SeqRecord

    g = "".join("ACGT"[i] for i in rng.integers(0, 4, n))
    return g, build_index([SeqRecord("chr1", g.encode(), None, None)], 10,
                          15, 0, np.zeros(0, np.uint64))


def _recorded_map_batch(monkeypatch, mi, mo, seqs):
    """map_batch on the CPU, recording (jobs, flag, end_bonus) of every
    DevCallPooled call."""
    from winnowmap_tpu_torch.map import engine
    from winnowmap_tpu_torch.map.batch import STATS, map_batch

    seen = []

    class Recording(K.DevCallPooled):
        def __init__(self, pools, jobs, mat, q, e, q2, e2, end_bonus, flag,
                     *a, **kw):
            seen.append((np.array(jobs), int(flag), np.array(end_bonus)))
            super().__init__(pools, jobs, mat, q, e, q2, e2, end_bonus, flag,
                             *a, **kw)

    monkeypatch.setattr(engine, "DevCallPooled", Recording)
    STATS.clear()
    got = map_batch(mi, mo, seqs, ["r"] * len(seqs), device="cpu")
    return got, seen, dict(STATS)


def _map_ont(mi, **kw):
    from winnowmap_tpu_torch.options import (MM_F_CIGAR, IndexOptions,
                                             MapOptions, set_preset,
                                             update_mid_occ)

    io_, mo = IndexOptions(), MapOptions()
    set_preset("map-ont", io_, mo)
    mo = replace(mo, flag=mo.flag | MM_F_CIGAR, **kw)
    update_mid_occ(mo, mi)
    return mo


def test_jobs_above_32768_leave_the_engine(monkeypatch):
    """Repair (a): a right extension whose query side is above 32768 (the
    engine's old MAX_DEV_LEN) is exported to the device path, and no job
    stays on the engine's host DP.  The read's tail is random, so the job
    z-drops within a few hundred anti-diagonals."""
    rng = np.random.default_rng(11)
    g, mi = _genome_and_index(rng, 50000)
    tail = "".join("ACGT"[i] for i in rng.integers(0, 4, 33000))
    read = (g[5000:8000] + tail).encode()
    mo = _map_ont(mi, sv_aware=False, max_gap=40000, q2=4, e2=2)
    got, seen, st = _recorded_map_batch(monkeypatch, mi, mo, [read])
    jobs = np.concatenate([j for j, _, _ in seen])
    assert st["eng_host_dp_calls"] == 0
    assert st["delivered_jobs"] == st["dev_jobs"] == len(jobs)
    assert (jobs[:, 1] > 32768).any()
    assert got[0].regs and got[0].regs[0].p is not None


@pytest.mark.parametrize("gaps", [{}, {"q2": 4, "e2": 2}],
                         ids=["extd", "extz"])
def test_inversion_rescue_reaches_the_device_path(gaps, monkeypatch):
    """Repair (b): on a read whose middle 1500 bases are inverted, the
    inversion rescue's extension (flag 0x40, end_bonus -1, w = 1.5 bw, its
    query on the other read strand) arrives at DevCallPooled as an ordinary
    pool job; no job stays on the host, and the regions, the inverted one
    included, equal the JAX engine's."""
    from winnowmap_tpu.index.build import build_index as jbuild
    from winnowmap_tpu.io.fastx import SeqRecord as JRec
    from winnowmap_tpu.map.engine import map_batch_engine as jmap
    from winnowmap_tpu.options import IndexOptions as JIo
    from winnowmap_tpu.options import MapOptions as JMo
    from winnowmap_tpu.options import MM_F_CIGAR as JCIGAR
    from winnowmap_tpu.options import set_preset as jpreset
    from winnowmap_tpu.options import update_mid_occ as jmid

    rng = np.random.default_rng(1)
    g, mi = _genome_and_index(rng, 40000)
    comp = str.maketrans("ACGT", "TGCA")
    read = (g[12000:14000] + g[14000:15500].translate(comp)[::-1]
            + g[15500:17500]).encode()
    mo = _map_ont(mi, sv_aware=False, **gaps)
    got, seen, st = _recorded_map_batch(monkeypatch, mi, mo, [read])
    assert st["eng_host_dp_calls"] == 0
    assert st["delivered_jobs"] == st["dev_jobs"]
    inv = [r for r in got[0].regs if r.inv]
    assert len(inv) == 1 and abs(inv[0].rs - 14000) < 8
    rescue = [j for jobs, flag, eb in seen for j, b in zip(jobs, eb)
              if flag == 0x40 and b == -1 and j[6] == int(mo.bw * 1.5)
              and j[0] >= len(read) and j[3] == inv[0].rs]
    assert len(rescue) == 1

    monkeypatch.setenv("WM_NO_TPU", "1")
    jio, jmo = JIo(), JMo()
    jpreset("map-ont", jio, jmo)
    jmo = replace(jmo, flag=jmo.flag | JCIGAR, sv_aware=False, **gaps)
    jmi = jbuild([JRec("chr1", g.encode(), None, None)], 10, 15, 0,
                 np.zeros(0, np.uint64))
    jmid(jmo, jmi)
    assert_same_results(jmap(jmi, jmo, [read], ["r"]), got)
