"""The port's CUDA kernels on the card: K1 (csrc/extd.cu), K3
(csrc/exts.cu), K4 (csrc/extz.cu), K2 (csrc/traceback.cu, plain and
spliced) and the cost probes P1-P3 (csrc/probes.cu) against their plain
PyTorch versions on the same device tensors,
the pooled call on the card against the CPU, and map_batch on the card
against the CPU, map-ont, single-cost and spliced.  Integer DP: every
comparison is exact.

These tests need a CUDA card, nvcc and g++; without a card they skip.  On a
machine with a card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(--noconftest: the suite's conftest.py imports JAX, which the port and its
card's host do not need.)
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from winnowmap_tpu_torch import native, tools
from winnowmap_tpu_torch.extend import _build
from winnowmap_tpu_torch.extend import check
from winnowmap_tpu_torch.extend import kernels as K
from winnowmap_tpu_torch.index.build import MinimizerIndex
from winnowmap_tpu_torch.map.align import gen_simple_mat
from winnowmap_tpu_torch.tools import check as PC
from winnowmap_tpu_torch.tools import probe_bisect as P1
from winnowmap_tpu_torch.tools import probe_l0 as P2

pytestmark = pytest.mark.gpu

GOLD = Path(__file__).resolve().parent / "data" / "golden"
# map-ont and asm5 (a, b, q, e, q2, e2): asm5's q2=81 drives int8 wraps
PROFILES = {"map-ont": (2, 4, 4, 2, 24, 1), "asm5": (1, 19, 39, 3, 81, 1)}
FLAGS = (0x18, 0x0, 0xC2, 0x40, 0x01)
# splice and splice:hq (a, b, q, e, q2, noncan, junc_bonus)
SPLICE = {"splice": (1, 2, 2, 1, 32, 9, 9), "splice:hq": (1, 4, 6, 1, 24, 9, 5)}
SPLICE_FLAGS = (0x100 | 0x400, 0x200 | 0x400, 0x300 | 0x18,
                0x100 | 0x40 | 0x02 | 0x80, 0x100 | 0x01, 0x00)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batch(seed, B=24, lo=30, hi=700):
    """Pools and (B, 8) job rows: mutated pairs plus one dissimilar pair,
    mixed band widths (-1 = full), z-drops and strands."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, B - 1)
    ws = rng.choice([-1, 33, 64, 97, 500], B)
    zdrops = rng.choice([40, 200, 400], B)
    qpool, tpool, jobs, _, _ = check.random_jobs(rng, lens, ws, zdrops,
                                                 dissimilar=True)
    return qpool, tpool, jobs, rng.integers(0, 60, B)


def _on_card(dev, qpool, tpool, jobs, profile, flag, eb):
    a, b, q, e, q2, e2 = PROFILES[profile]
    return check.OnDevice(dev, qpool, tpool, jobs, gen_simple_mat(a, b, 1),
                          (q, e, q2, e2), flag, eb)


def _check_kernels_against_plain(c: check.OnDevice):
    n0 = dict(K.LAUNCHES)
    err, _, _, _ = check.check_against_plain(c)
    torch.cuda.synchronize()
    assert err == {c.dp_name: 0, "traceback": 0}
    # the DP kernel once; K2 on its direction bytes and on the plain one's
    n2 = 0 if c.flag & K.EZ_SCORE_ONLY else 2
    assert K.LAUNCHES[c.dp_name] == n0[c.dp_name] + 1
    assert K.LAUNCHES["traceback"] == n0["traceback"] + n2


@pytest.mark.parametrize("flag", FLAGS, ids=lambda f: f"flag{f:#04x}")
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_kernels_match_plain(cuda, profile, flag):
    qpool, tpool, jobs, eb = _batch(7)
    _check_kernels_against_plain(
        _on_card(cuda, qpool, tpool, jobs, profile, flag, eb))


@pytest.mark.parametrize("flag", (0x18, 0x0), ids=("flag0x18", "flag0x00"))
def test_extd_kernel_global_ring_matches_plain(cuda, flag, monkeypatch):
    """The band ring in global scratch (bands too wide for shared memory)
    computes what the shared-memory ring does."""
    monkeypatch.setattr(_build, "EXTD_SMEM_MAX", 0)
    qpool, tpool, jobs, eb = _batch(11, B=12)
    _check_kernels_against_plain(
        _on_card(cuda, qpool, tpool, jobs, "map-ont", flag, eb))


def test_long_full_band_job_matches_native(cuda):
    """One job whose full band (w = -1) needs the 256-thread, global-ring
    launch, against the native oracle."""
    rng = np.random.default_rng(5)
    t = rng.integers(0, 4, 8400).astype(np.uint8)
    q = check.mutate(rng, t, 0.08)
    a, b, qo, e, q2, e2 = PROFILES["map-ont"]
    mat = gen_simple_mat(a, b, 1)
    mi = MinimizerIndex(w=10, k=15, codes=t)
    pools = K.PoolContext(q, mi, cuda)
    jobs = np.array([[0, len(q), 0, 0, len(t), 0, -1, 400]], np.int64)
    assert K.job_geometry(jobs).cap > 8192
    res9, blob, off, ln, _ = K.DevCallPooled(
        pools, jobs, mat, qo, e, q2, e2, 0, 0x0).collect_blob()
    h = native.extd(q, t, mat, qo, e, q2, e2, -1, 400, 0, 0x0)
    assert res9[0].tolist() == [h.max, int(h.zdropped), h.max_q, h.max_t,
                                h.mqe, h.mqe_t, h.mte, h.mte_q, h.score]
    assert np.array_equal(blob[off[0]:off[0] + ln[0]], h.cigar)


@pytest.mark.parametrize("flag", FLAGS, ids=lambda f: f"flag{f:#04x}")
def test_pooled_call_on_card_matches_cpu(cuda, flag):
    qpool, tpool, jobs, eb = _batch(3)
    a, b, q, e, q2, e2 = PROFILES["asm5"]
    mat = gen_simple_mat(a, b, 1)
    out = []
    for dev in (cuda, torch.device("cpu")):
        mi = MinimizerIndex(w=10, k=15, codes=tpool)
        pools = K.PoolContext(qpool, mi, dev)
        out.append(K.DevCallPooled(pools, jobs, mat, q, e, q2, e2, eb,
                                   flag).collect_blob())
    (res_g, blob_g, off_g, ln_g, reach_g), (res_c, blob_c, off_c, ln_c,
                                            reach_c) = out
    assert np.array_equal(res_g, res_c) and np.array_equal(reach_g, reach_c)
    if flag & K.EZ_SCORE_ONLY:
        assert blob_g is None and blob_c is None
        return
    assert np.array_equal(ln_g, ln_c)
    for i in range(len(jobs)):
        assert np.array_equal(blob_g[off_g[i]:off_g[i] + ln_g[i]],
                              blob_c[off_c[i]:off_c[i] + ln_c[i]]), i


def test_map_batch_on_card_matches_cpu(cuda):
    from winnowmap_tpu_torch.index.build import build_index, load_weight_set
    from winnowmap_tpu_torch.io.fastx import read_all
    from winnowmap_tpu_torch.map.batch import STATS, map_batch
    from winnowmap_tpu_torch.options import (MM_F_CIGAR, IndexOptions,
                                             MapOptions, update_mid_occ)

    io_, mo = IndexOptions(), MapOptions()
    mo.flag |= MM_F_CIGAR
    mi = build_index(read_all(str(GOLD / "t_ref.fa")), io_.w, io_.k,
                     io_.flag, load_weight_set(str(GOLD / "t_rep_k15.txt"),
                                               io_.k))
    update_mid_occ(mo, mi)
    reads = read_all(str(GOLD / "t_reads.fa"))[:12]
    seqs, names = [r.seq for r in reads], [r.name for r in reads]
    ref = map_batch(mi, mo, seqs, names, device="cpu")
    STATS.clear()
    K.reset_launches()
    got = map_batch(mi, mo, seqs, names)
    assert K.LAUNCHES["extd"] > 0 and K.LAUNCHES["traceback"] > 0
    assert STATS["delivered_jobs"] == STATS["dev_jobs"] > 0

    def key(r):
        return (r.rid, r.score, r.qs, r.qe, r.rs, r.re, r.mapq, r.rev,
                None if r.p is None else (r.p.dp_score, r.p.dp_max,
                                          tuple(r.p.cigar.tolist())))

    assert [[key(r) for r in x.regs] for x in got] == \
        [[key(r) for r in x.regs] for x in ref]


def _spliced_on_card(dev, profile, flag, B=24, seed=13, **kw):
    rng = np.random.default_rng(seed)
    qpool, tpool, jobs, qs, ts, js = check.spliced_jobs(
        rng, B, rev=bool(flag & K.EZ_REV_CIGAR), **kw)
    a, b, q, e, q2, noncan, jb = SPLICE[profile]
    c = check.OnDevice(dev, qpool, tpool, jobs, gen_simple_mat(a, b, 1),
                       (q, e, q2), flag, 0, splice=(noncan, jb), juncs=js)
    return c, qs, ts, js


@pytest.mark.parametrize("flag", SPLICE_FLAGS, ids=lambda f: f"flag{f:#05x}")
@pytest.mark.parametrize("profile", sorted(SPLICE))
def test_exts_kernels_match_plain(cuda, profile, flag):
    """K3 and K2's spliced form against their plain versions, with junction
    bytes on a third of the jobs."""
    c, _, _, _ = _spliced_on_card(cuda, profile, flag)
    _check_kernels_against_plain(c)


@pytest.mark.parametrize("flag", (0x300 | 0x18, 0x100 | 0x400))
def test_exts_kernel_global_ring_matches_plain(cuda, flag, monkeypatch):
    """K3's large-band path with its slot state in global scratch, forced
    on bands the register variants would hold."""
    monkeypatch.setattr(K, "K3_VARIANTS", {})
    monkeypatch.setattr(K, "K3_SMEM_MAX", 0)
    c, _, _, _ = _spliced_on_card(cuda, "splice", flag, B=12)
    assert c.k3.path == "mem-global"
    _check_kernels_against_plain(c)


# every launch K3's geometry can choose: (threads, slots a thread); 0 slots
# is the large-band path, its state in shared memory or global scratch
K3_LAUNCHES = [(nt, spt) for nt, spts in sorted(K.K3_VARIANTS.items())
               for spt in spts] + [(K.K3_MEM_THREADS, 0, "smem"),
                                   (K.K3_MEM_THREADS, 0, "global")]


@pytest.mark.parametrize("flag", (0x508, 0x100 | 0x40 | 0x02 | 0x80),
                         ids=lambda f: f"flag{f:#05x}")
@pytest.mark.parametrize("launch", K3_LAUNCHES,
                         ids=lambda v: "-".join(map(str, v)))
def test_exts_kernel_launches_match_plain(cuda, launch, flag, monkeypatch):
    """K3 at each launch it can take, on jobs whose targets are longer
    than the ring (the band wraps it), against the plain version; the
    memory path is forced on a ring of 2048 lanes."""
    nt, spt = launch[:2]
    ring = nt * spt if spt else 2048
    if spt == 0:
        monkeypatch.setattr(K, "K3_VARIANTS", {})
        if launch[2] == "global":
            monkeypatch.setattr(K, "K3_SMEM_MAX", 0)
    # bands up to ring - 64 lanes; introns up to 700 bases or ring / 2
    c, _, _, _ = _spliced_on_card(cuda, "splice", flag, B=8, seed=spt + nt,
                                  exon_total=(120, min(800, ring - 80)),
                                  intron_len=(100, max(700, ring // 2)))
    assert c.geo.cap <= ring and (c.jobs_np[:, 4] > ring).any()
    g = K.exts_geometry(ring, c.geo.qlen_max)
    assert (g.threads, g.spt, g.ring) == (nt, spt, ring)
    if spt == 0:
        assert g.mem_smem == (launch[2] == "smem")
    c.k3 = g
    _check_kernels_against_plain(c)


def test_exts_kernel_query_from_pool_matches_plain(cuda, monkeypatch):
    """A query longer than K3 stages in shared memory is read from the
    pool in every cell."""
    monkeypatch.setattr(K, "K3_QSTAGE_MAX", 256)
    c, _, _, _ = _spliced_on_card(cuda, "splice:hq", 0x300 | 0x18, B=12)
    assert c.k3.qstage == 256 and c.geo.qlen_max > 256
    _check_kernels_against_plain(c)


def _pair_jobs(pairs, w, zdrop=-1):
    """Pools and job rows of (query, target) pairs, one band for all."""
    qs, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    jobs = np.zeros((len(pairs), 8), np.int64)
    jobs[:, 0] = np.cumsum([0] + [len(x) for x in qs])[:-1]
    jobs[:, 1] = [len(x) for x in qs]
    jobs[:, 3] = np.cumsum([0] + [len(x) for x in ts])[:-1]
    jobs[:, 4] = [len(x) for x in ts]
    jobs[:, 6] = w
    jobs[:, 7] = zdrop
    return (np.concatenate(qs + [np.zeros(16, np.uint8)]),
            np.concatenate(ts + [np.zeros(16, np.uint8)]), jobs)


def _window_pairs(case, rng):
    """Pairs whose traceback leaves K2's 32-row window at its edges: long
    insertion (I) runs, M runs that climb the lane offset of a narrow
    band, and short jobs whose walk starts below and just above r = 32
    and r = 64."""
    out = []
    for n in (200, 700, 1100):
        t = rng.integers(0, 4, n).astype(np.uint8)
        if case == "long-I":
            k = int(rng.integers(20, n - 20))
            ins = rng.integers(0, 4, int(rng.integers(33, 200)))
            out.append((np.concatenate([t[:k], ins, t[k:]]).astype(np.uint8),
                        t))
        elif case == "M-climb":
            out.append((check.mutate(rng, t, 0.01), t))
        else:
            for m in (1, 2, 5, 17, 31, 33, 63, 65):
                tt = rng.integers(0, 4, m).astype(np.uint8)
                out.append((check.mutate(rng, tt, 0.1) if m > 2 else tt, tt))
    return out


@pytest.mark.parametrize("flag", (0x0, 0x18, 0xC2))
@pytest.mark.parametrize("case", ("long-I", "M-climb", "short"))
def test_traceback_windows_match_plain(cuda, case, flag):
    """K2 against the plain traceback on paths that leave its window at
    the edges (map-ont, banded w = 64 and full band)."""
    rng = np.random.default_rng(17)
    pairs = _window_pairs(case, rng)
    for w in (64, -1):
        qpool, tpool, jobs = _pair_jobs(pairs, w)
        c = _on_card(cuda, qpool, tpool, jobs, "map-ont", flag, 0)
        _check_kernels_against_plain(c)


@pytest.mark.parametrize("flag", (0x508, 0x100 | 0x40 | 0x02 | 0x80, 0x0),
                         ids=lambda f: f"flag{f:#05x}")
def test_spliced_traceback_long_introns_matches_plain(cuda, flag):
    """K2's spliced form on long N runs through introns of about 1,500
    bases, and the D runs of the profile without splice sites (flag 0)."""
    c, _, _, _ = _spliced_on_card(cuda, "splice", flag, B=8, seed=19,
                                  intron_len=(1450, 1550))
    _check_kernels_against_plain(c)
    res, dirs = c.k1_plain()
    ops, _ = c.k2_plain(dirs, c.starts(res))
    if flag & 0x300:
        assert int((ops == 3).sum()) >= 1400


def test_long_unbanded_exts_job_matches_native(cuda):
    """One spliced job whose unbanded band passes 8192 lanes (K3's
    large-band path, its slot state in global scratch) against
    native.exts."""
    c, qs, ts, _ = _spliced_on_card(
        cuda, "splice", 0x100 | 0x400, B=1, seed=5, junc_frac=0,
        exon_total=(8600, 8600), n_exons=(4, 4))
    assert c.geo.cap > 8192 and c.k3.path == "mem-global"
    res, dirs = c.k1()
    ops, fin = c.k2(dirs, c.starts(res))
    a, b, q, e, q2, noncan, jb = SPLICE["splice"]
    h = native.exts(qs[0], ts[0], gen_simple_mat(a, b, 1), q, e, q2, noncan,
                    int(c.jobs_np[0, 7]), jb, 0x100 | 0x400)
    assert res[0, :9].tolist() == [h.max, int(h.zdropped), h.max_q, h.max_t,
                                   h.mqe, h.mqe_t, h.mte, h.mte_q, h.score]
    assert np.array_equal(c.cigars(native, ops, fin)[0], h.cigar)


def _recorded_map_batch(monkeypatch, mi, mo, seqs, names):
    """map_batch on the card, recording the job rows of every device call."""
    from winnowmap_tpu_torch.map import engine
    from winnowmap_tpu_torch.map.batch import STATS, map_batch

    seen = []

    class Recording(K.DevCallPooled):
        def __init__(self, pools, jobs, *a, **kw):
            seen.append(np.array(jobs))
            super().__init__(pools, jobs, *a, **kw)

    monkeypatch.setattr(engine, "DevCallPooled", Recording)
    STATS.clear()
    out = map_batch(mi, mo, seqs, names)
    return out, np.concatenate(seen), dict(STATS)


def _long_tail_read(seed, genome_len, keep, tail):
    """A genome and one read: `keep` bases of it and then a random tail, so
    the read's right extension is a job with a long query and target."""
    from winnowmap_tpu_torch.index.build import build_index
    from winnowmap_tpu_torch.io.fastx import SeqRecord

    rng = np.random.default_rng(seed)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, genome_len))
    read = g[5000:5000 + keep] + "".join(
        "ACGT"[i] for i in rng.integers(0, 4, tail))
    mi = build_index([SeqRecord("chr1", g.encode(), None, None)], 25, 15, 0,
                     np.zeros(0, np.uint64))
    return mi, read.encode()


def test_long_jobs_reach_the_card(cuda, monkeypatch):
    """Jobs beyond the TPU kernel's limits run on the card: an exts job
    whose shorter side is above 4096 and an extd job with w + 1 > 6000 and
    both sides above 6000; the engine keeps none on the host."""
    from dataclasses import replace

    from winnowmap_tpu_torch.options import (MM_F_CIGAR, IndexOptions,
                                             MapOptions, set_preset,
                                             update_mid_occ)

    mi, read = _long_tail_read(3, 60000, 3000, 5000)
    io_, mo = IndexOptions(), MapOptions()
    set_preset("splice", io_, mo)
    mo = replace(mo, flag=mo.flag | MM_F_CIGAR, max_gap=10000)
    update_mid_occ(mo, mi)
    _, jobs, st = _recorded_map_batch(monkeypatch, mi, mo, [read], ["r"])
    assert st["eng_host_dp_calls"] == 0
    assert (np.minimum(jobs[:, 1], jobs[:, 4]) > 4096).any()

    mi, read = _long_tail_read(4, 60000, 3000, 7000)
    io_, mo = IndexOptions(), MapOptions()
    set_preset("map-ont", io_, mo)
    mo = replace(mo, flag=mo.flag | MM_F_CIGAR, max_gap=10000, bw=10000,
                 sv_aware=False)
    update_mid_occ(mo, mi)
    _, jobs, st = _recorded_map_batch(monkeypatch, mi, mo, [read], ["r"])
    assert st["eng_host_dp_calls"] == 0
    assert ((jobs[:, 6] + 1 > 6000) & (jobs[:, 1] > 6000)
            & (jobs[:, 4] > 6000)).any()


@pytest.mark.parametrize("preset", ["splice", "splice:hq"])
def test_splice_map_batch_on_card_matches_cpu(cuda, preset):
    from winnowmap_tpu_torch.index.build import build_index, load_weight_set
    from winnowmap_tpu_torch.io.fastx import read_all
    from winnowmap_tpu_torch.map.batch import STATS, map_batch
    from winnowmap_tpu_torch.options import (MM_F_CIGAR, IndexOptions,
                                             MapOptions, set_preset,
                                             update_mid_occ)

    io_, mo = IndexOptions(), MapOptions()
    set_preset(preset, io_, mo)
    mo.flag |= MM_F_CIGAR
    mi = build_index(read_all(str(GOLD / "s_ref.fa")), io_.w, io_.k,
                     io_.flag, load_weight_set(str(GOLD / "s_rep_k15.txt"),
                                               io_.k))
    update_mid_occ(mo, mi)
    reads = read_all(str(GOLD / "s_reads.fa"))
    seqs, names = [r.seq for r in reads], [r.name for r in reads]
    ref = map_batch(mi, mo, seqs, names, device="cpu")
    STATS.clear()
    K.reset_launches()
    got = map_batch(mi, mo, seqs, names)
    assert K.LAUNCHES["exts"] > 0 and K.LAUNCHES["traceback"] > 0
    assert K.LAUNCHES["extd"] == 0
    assert STATS["delivered_jobs"] == STATS["dev_jobs"] > 0

    def key(r):
        return (r.rid, r.score, r.qs, r.qe, r.rs, r.re, r.mapq, r.rev,
                None if r.p is None else (r.p.dp_score, r.p.dp_max,
                                          r.p.trans_strand,
                                          tuple(r.p.cigar.tolist())))

    assert [[key(r) for r in x.regs] for x in got] == \
        [[key(r) for r in x.regs] for x in ref]


# one gap cost (a, b, q, e, q2, e2), and the profile whose biased score
# byte wraps (q + e = 63, max_sc = 128); its jobs run without z-drop
EXTZ = {"single": (2, 4, 4, 2, 4, 2), "wrap": (2, 4, 61, 2, 61, 2)}


def _extz_on_card(dev, profile, flag, seed=7, B=24):
    qpool, tpool, jobs, eb = _batch(seed, B=B)
    if profile == "wrap":
        jobs[:, 7] = -1
    a, b, q, e, q2, e2 = EXTZ[profile]
    c = check.OnDevice(dev, qpool, tpool, jobs, gen_simple_mat(a, b, 1),
                       (q, e, q2, e2), flag, eb)
    assert c.dp_name == "extz"
    return c


@pytest.mark.parametrize("flag", FLAGS, ids=lambda f: f"flag{f:#04x}")
@pytest.mark.parametrize("profile", sorted(EXTZ))
def test_extz_kernels_match_plain(cuda, profile, flag):
    _check_kernels_against_plain(_extz_on_card(cuda, profile, flag))


@pytest.mark.parametrize("flag", (0x18, 0x0), ids=("flag0x18", "flag0x00"))
def test_extz_kernel_global_ring_matches_plain(cuda, flag, monkeypatch):
    monkeypatch.setattr(_build, "EXTD_SMEM_MAX", 0)
    _check_kernels_against_plain(_extz_on_card(cuda, "single", flag, 11,
                                               B=12))


def test_long_full_band_extz_job_matches_native(cuda):
    """One single-cost job whose full band needs the 256-thread,
    global-ring launch, against native.extz."""
    rng = np.random.default_rng(5)
    t = rng.integers(0, 4, 8400).astype(np.uint8)
    q = check.mutate(rng, t, 0.08)
    mat = gen_simple_mat(2, 4, 1)
    mi = MinimizerIndex(w=10, k=15, codes=t)
    pools = K.PoolContext(q, mi, cuda)
    jobs = np.array([[0, len(q), 0, 0, len(t), 0, -1, 400]], np.int64)
    assert K.job_geometry(jobs).cap > 8192
    n0 = K.LAUNCHES["extz"]
    res9, blob, off, ln, _ = K.DevCallPooled(
        pools, jobs, mat, 4, 2, 4, 2, 0, 0x0).collect_blob()
    assert K.LAUNCHES["extz"] == n0 + 1
    h = native.extz(q, t, mat, 4, 2, -1, 400, 0, 0x0)
    assert res9[0].tolist() == [h.max, int(h.zdropped), h.max_q, h.max_t,
                                h.mqe, h.mqe_t, h.mte, h.mte_q, h.score]
    assert np.array_equal(blob[off[0]:off[0] + ln[0]], h.cigar)


def test_single_cost_map_batch_on_card_matches_cpu(cuda):
    from dataclasses import replace

    from winnowmap_tpu_torch.index.build import build_index, load_weight_set
    from winnowmap_tpu_torch.io.fastx import read_all
    from winnowmap_tpu_torch.map.batch import STATS, map_batch
    from winnowmap_tpu_torch.options import (MM_F_CIGAR, IndexOptions,
                                             MapOptions, update_mid_occ)

    io_, mo = IndexOptions(), MapOptions()
    mo.flag |= MM_F_CIGAR
    mo = replace(mo, q2=mo.q, e2=mo.e)
    mi = build_index(read_all(str(GOLD / "t_ref.fa")), io_.w, io_.k,
                     io_.flag, load_weight_set(str(GOLD / "t_rep_k15.txt"),
                                               io_.k))
    update_mid_occ(mo, mi)
    reads = read_all(str(GOLD / "t_reads.fa"))[:12]
    seqs, names = [r.seq for r in reads], [r.name for r in reads]
    ref = map_batch(mi, mo, seqs, names, device="cpu")
    STATS.clear()
    K.reset_launches()
    got = map_batch(mi, mo, seqs, names)
    assert K.LAUNCHES["extz"] > 0 and K.LAUNCHES["traceback"] > 0
    assert K.LAUNCHES["extd"] == 0
    assert STATS["delivered_jobs"] == STATS["dev_jobs"] > 0
    assert STATS["eng_host_dp_calls"] == 0

    def key(r):
        return (r.rid, r.score, r.qs, r.qe, r.rs, r.re, r.mapq, r.rev,
                None if r.p is None else (r.p.dp_score, r.p.dp_max,
                                          tuple(r.p.cigar.tolist())))

    assert [[key(r) for r in x.regs] for x in got] == \
        [[key(r) for r in x.regs] for x in ref]


def test_long_and_inversion_jobs_reach_the_card(cuda, monkeypatch):
    """The engine's two repaired cases run on the card: a right extension
    whose query side is above 32768, and the inversion rescue's extension
    (flag 0x40, its query on the other read strand); no job stays on the
    host, and the inverted region comes back."""
    from dataclasses import replace

    from winnowmap_tpu_torch.index.build import build_index
    from winnowmap_tpu_torch.io.fastx import SeqRecord
    from winnowmap_tpu_torch.options import (MM_F_CIGAR, IndexOptions,
                                             MapOptions, set_preset,
                                             update_mid_occ)

    rng = np.random.default_rng(11)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 50000))
    mi = build_index([SeqRecord("chr1", g.encode(), None, None)], 10, 15, 0,
                     np.zeros(0, np.uint64))
    io_, mo = IndexOptions(), MapOptions()
    set_preset("map-ont", io_, mo)
    mo = replace(mo, flag=mo.flag | MM_F_CIGAR, sv_aware=False,
                 max_gap=40000)
    update_mid_occ(mo, mi)
    tail = "".join("ACGT"[i] for i in rng.integers(0, 4, 33000))
    comp = str.maketrans("ACGT", "TGCA")
    inverted = (g[20000:24000] + g[24000:25500].translate(comp)[::-1]
                + g[25500:29500])
    reads = [(g[5000:8000] + tail).encode(), inverted.encode()]
    K.reset_launches()
    out, jobs, st = _recorded_map_batch(monkeypatch, mi, mo, reads,
                                        ["long", "inv"])
    assert st["eng_host_dp_calls"] == 0
    assert st["delivered_jobs"] == st["dev_jobs"] == len(jobs)
    assert K.LAUNCHES["extd"] > 0
    assert (jobs[:, 1] > 32768).any()
    inv = [r for r in out[1].regs if r.inv]
    assert len(inv) == 1 and abs(inv[0].rs - 24000) < 8
    assert ((jobs[:, 0] >= len(reads[0]) * 2 + len(reads[1]))
            & (jobs[:, 3] == inv[0].rs)).any()


# the cost probes P1-P3 (csrc/probes.cu) against their plain versions at
# the small shape of chip_smoke.py's phase 7


@pytest.mark.parametrize("level,dirs_mode,s32", PC.core_cases(),
                         ids=[f"L{c[0]}-{c[1]}{'-s32' * c[2]}"
                              for c in PC.core_cases()])
def test_probe_core_kernel_matches_plain(cuda, level, dirs_mode, s32):
    qbuf, qlen = PC.small_inputs(cuda)
    before = tools.LAUNCHES["probe_core"]
    assert PC.check_core(qbuf, qlen, level, dirs_mode, s32) == 0
    assert tools.LAUNCHES["probe_core"] == before + 1


def test_probe_l0_kernel_matches_plain(cuda):
    _, qlen = PC.small_inputs(cuda)
    assert max(PC.check_l0(qlen, kv) for _, kv in P2.cases) == 0


def test_probe_bisect_kernel_matches_plain(cuda):
    _, qlen = PC.small_inputs(cuda)
    assert max(PC.check_bisect(qlen, body, kv)
               for _, body, kv in P1.variants) == 0


# the same at the shapes the entry points time (P3: every level and
# variant at Wb 640 and its ROWS, 8 jobs, ~320 rows)


@pytest.mark.parametrize("level,dirs_mode,s32,rows",
                         [c[1:] for c in PC.timed_core_cases()],
                         ids=[c[0] for c in PC.timed_core_cases()])
def test_probe_core_kernel_matches_plain_at_timed_shape(cuda, level,
                                                        dirs_mode, s32, rows):
    assert PC.check_timed_core(cuda, level, dirs_mode, s32, rows) == 0


def test_probe_l0_kernel_matches_plain_at_timed_shapes(cuda):
    assert max(PC.check_timed_l0(cuda, kv) for _, kv in P2.cases) == 0


def test_probe_bisect_kernel_matches_plain_at_timed_shape(cuda):
    assert max(PC.check_timed_bisect(cuda, body, kv)
               for _, body, kv in P1.variants) == 0
