"""The port's CUDA kernels on the card: K1 (csrc/extd.cu), K3
(csrc/exts.cu), K4 (csrc/extz.cu), K2 (csrc/traceback.cu, plain and
spliced), R1 (csrc/cigar.cu, also against the native decode), the cost
probes P1-P3 (csrc/probes.cu), C1 (csrc/chain.cu), S1 (csrc/sketch.cu) and
KC (csrc/kcount.cu) against their plain PyTorch
versions on the same device tensors (KC's counts of the golden genome also
against the host counter and meryl's goldens; C1's chains and S1's
sketches also against the native oracles,
the index built through S1 against the native build, the engine's chain
exchange and the generator path's chains on the card against the host's),
the pooled call on the card against the CPU, map_batch on the card
against the CPU, map-ont, single-cost and spliced, and the generator path
(--junc-bed) on the card against its golden and against the CPU.  Integer
DP: every comparison is exact.

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
    """K1's memory path with its slot state in global scratch (rings too
    wide for shared memory), forced on bands the register launches would
    hold, computes what they do."""
    monkeypatch.setattr(K, "EXT_VARIANTS", {})
    monkeypatch.setattr(K, "EXT_SMEM_MAX", 0)
    qpool, tpool, jobs, eb = _batch(11, B=12)
    c = _on_card(cuda, qpool, tpool, jobs, "map-ont", flag, eb)
    assert c.ext.path == "mem-global"
    _check_kernels_against_plain(c)


def test_long_full_band_job_matches_native(cuda):
    """One job whose full band (w = -1) needs K1's memory path with its
    slot state in global scratch, against the native oracle."""
    rng = np.random.default_rng(5)
    t = rng.integers(0, 4, 16800).astype(np.uint8)
    q = check.mutate(rng, t, 0.08)
    a, b, qo, e, q2, e2 = PROFILES["map-ont"]
    mat = gen_simple_mat(a, b, 1)
    mi = MinimizerIndex(w=10, k=15, codes=t)
    pools = K.PoolContext(q, mi, cuda)
    jobs = np.array([[0, len(q), 0, 0, len(t), 0, -1, 400]], np.int64)
    geo = K.job_geometry(jobs)
    assert K.ext_geometry(geo.span, geo.qlen_max).path == "mem-global"
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


def test_two_engines_on_one_card_match_one(cuda, monkeypatch):
    """The split driver (ways 2: map_batch_multidev over [cuda, cuda], two
    engines, two host threads, a stream each) equals one engine on the
    card; the DP launch counts equal the sum of what each engine's thread
    launched, both threads launched, and no job stays on the host."""
    import threading

    from winnowmap_tpu_torch.index.build import build_index, load_weight_set
    from winnowmap_tpu_torch.io.fastx import read_all
    from winnowmap_tpu_torch.map.engine import (STATS, map_batch_engine,
                                                map_batch_engine_pipelined)
    from winnowmap_tpu_torch.options import (MM_F_CIGAR, IndexOptions,
                                             MapOptions, update_mid_occ)

    io_, mo = IndexOptions(), MapOptions()
    mo.flag |= MM_F_CIGAR
    mi = build_index(read_all(str(GOLD / "t_ref.fa")), io_.w, io_.k,
                     io_.flag, load_weight_set(str(GOLD / "t_rep_k15.txt"),
                                               io_.k))
    update_mid_occ(mo, mi)
    reads = read_all(str(GOLD / "t_reads.fa")) * 2  # 120: two split ways
    seqs, names = [r.seq for r in reads], [r.name for r in reads]
    one = map_batch_engine(mi, mo, seqs, names, cuda)
    seen = []  # (thread, key, n) of every launch counted
    real = K.count

    def spy(counter, key, n=1):
        if counter is K.LAUNCHES:
            seen.append((threading.current_thread().name, key, n))
        real(counter, key, n)

    monkeypatch.setattr(K, "count", spy)
    K.reset_launches()
    STATS.clear()
    split = map_batch_engine_pipelined(mi, mo, seqs, names, cuda, ways=2)
    for key in ("extd", "traceback"):
        by = {}
        for t, k, n in seen:
            if k == key:
                by[t] = by.get(t, 0) + n
        assert set(by) == {"wm-dev0", "wm-dev1"}, by
        assert K.LAUNCHES[key] == sum(by.values()) > 0
    assert STATS["eng_host_dp_calls"] == 0
    assert STATS["delivered_jobs"] == STATS["dev_jobs"] > 0

    def key(r):
        return (r.rid, r.score, r.qs, r.qe, r.rs, r.re, r.mapq, r.rev,
                None if r.p is None else (r.p.dp_score, r.p.dp_max,
                                          tuple(r.p.cigar.tolist())))

    assert [[key(r) for r in x.regs] for x in split] == \
        [[key(r) for r in x.regs] for x in one]


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


# R1 on check.random_op_rows: (spliced, min_intron, rev, jobs, n_ops,
# reach); n_ops 2,052 takes the byte loads; the wide calls' widest rows are
# 200,000 diagonals, beside rows of a few hundred
RLE_CARD = {
    "2bit": (False, 0, False, 64, 4112, None),
    "4bit-rev": (True, 30, True, 64, 4112, None),
    "byte-loads": (True, 30, False, 64, 2052, None),
    "wide-4bit": (True, 30, False, 64, 200_000, 400),
    "wide-2bit-rev": (False, 0, True, 64, 200_000, 400),
}


@pytest.mark.parametrize("case", sorted(RLE_CARD))
def test_cigar_rle_kernel_matches_plain_and_native(cuda, case):
    """R1 (csrc/cigar.cu) against its plain version on the card and
    against the native decode of the same rows."""
    spliced, min_intron, rev, B, n_ops, reach = RLE_CARD[case]
    ops, fin, start = check.random_op_rows(
        np.random.default_rng(len(case)), spliced, min_intron, B, n_ops,
        reach)
    t = [torch.from_numpy(a).to(cuda) for a in (ops, fin, start)]
    n0 = K.LAUNCHES["rle"]
    assert check.rle_err(*t, rev, min_intron) == 0
    blob, off, ln = K.cigar_rle(*t, rev, min_intron)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rle"] == n0 + 2
    want = check.native_cigars(native, ops, fin, rev, spliced, min_intron)
    words = blob.cpu().numpy().view(np.uint32)
    assert max(map(len, want)) > 1000
    for b, (o, n) in enumerate(zip(off.tolist(), ln.tolist())):
        assert np.array_equal(words[o:o + n], want[b]), b


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


def test_generator_junc_bed_golden_on_card(cuda):
    """chip_smoke.py's phase 8 (a): -x splice --junc-bed s_junc.bed
    --junc-bonus 9 -c through the generator path on the card, byte-equal
    to golden_splice_junc.paf, every DP job on the card."""
    import contextlib
    import io

    from winnowmap_tpu_torch.cli import main
    from winnowmap_tpu_torch.map.batch import STATS

    STATS.clear()
    K.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["-x", "splice", "--junc-bed", str(GOLD / "s_junc.bed"),
                   "--junc-bonus", "9", "-c", "-W",
                   str(GOLD / "s_rep_k15.txt"), str(GOLD / "s_ref.fa"),
                   str(GOLD / "s_reads.fa")])
    assert rc == 0
    assert buf.getvalue() == (GOLD / "golden_splice_junc.paf").read_text()
    assert K.LAUNCHES["exts"] > 0 and K.LAUNCHES["traceback"] > 0
    assert STATS["dev_jobs"] > 0 and STATS["host_jobs"] == 0


def test_generator_junction_call_on_card_matches_cpu(cuda, monkeypatch):
    """One generator-path K3 call that carries junction bytes (from
    s_junc.bed), recorded on the card and run again on the CPU (the plain
    versions): every result field and CIGAR equal."""
    from dataclasses import replace

    from winnowmap_tpu_torch.index.build import (build_index,
                                                 load_weight_set, read_bed)
    from winnowmap_tpu_torch.io.fastx import read_all
    from winnowmap_tpu_torch.map import batch
    from winnowmap_tpu_torch.options import (MM_F_CIGAR, IndexOptions,
                                             MapOptions, set_preset,
                                             update_mid_occ)

    io_, mo = IndexOptions(), MapOptions()
    set_preset("splice", io_, mo)
    mo = replace(mo, flag=mo.flag | MM_F_CIGAR, junc_bonus=9)
    mi = build_index(read_all(str(GOLD / "s_ref.fa")), io_.w, io_.k,
                     io_.flag, load_weight_set(str(GOLD / "s_rep_k15.txt"),
                                               io_.k))
    update_mid_occ(mo, mi)
    read_bed(mi, str(GOLD / "s_junc.bed"))
    reads = read_all(str(GOLD / "s_reads.fa"))[:6]
    calls = []

    class Recording(K.DevCallPooled):
        def __init__(self, pools, jobs, *a, **kw):
            super().__init__(pools, jobs, *a, **kw)
            if kw.get("juncs") and any(j is not None for j in kw["juncs"]):
                calls.append((pools, np.array(jobs), a, kw, self.collect()))

    monkeypatch.setattr(batch, "DevCallPooled", Recording)
    batch.map_batch(mi, mo, [r.seq for r in reads], [r.name for r in reads])
    assert calls
    pools, jobs, a, kw, got = max(calls, key=lambda c: len(c[1]))
    cpu = K.PoolContext(pools.qpool.cpu().numpy(), mi, torch.device("cpu"))
    ref = K.DevCallPooled(cpu, jobs, *a, **kw).collect()
    for r, h in zip(got, ref):
        for f in native.ExtResult.__slots__:
            if f == "cigar":
                assert np.array_equal(r.cigar, h.cigar)
            else:
                assert getattr(r, f) == getattr(h, f), f


@pytest.mark.parametrize("flag,n", [("-D", 2), ("--for-only", 4),
                                    ("--rev-only", 4), ("--sr", 2)])
def test_generator_flags_on_card_match_cpu(cuda, flag, n, tmp_path):
    """The generator path's other flags on the first n golden reads (-D
    with the reads as their own reference; the single-strand flags on four
    reads, which hold both strands): the CLI's PAF on the card equals its
    PAF on the CPU (the plain versions, which the CPU tests hold to the
    JAX package)."""
    import contextlib
    import io

    from winnowmap_tpu_torch.cli import main
    from winnowmap_tpu_torch.map.batch import STATS

    recs = (GOLD / "t_reads.fa").read_text().split(">")[1:n + 1]
    reads = tmp_path / "reads.fa"
    reads.write_text("".join(">" + r for r in recs))
    ref = reads if flag == "-D" else GOLD / "t_ref.fa"
    argv = [flag, "-c", "-W", str(GOLD / "t_rep_k15.txt"), str(ref),
            str(reads)]
    outs = []
    for device in ("cuda", "cpu"):
        STATS.clear()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(list(argv), device=device) == 0
        assert STATS["dev_jobs"] > 0 and STATS["host_jobs"] == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "cg:Z:" in outs[0]


# one gap cost (a, b, q, e, q2, e2), and the profile whose biased score
# byte wraps (q + e = 63, max_sc = 128); its jobs run without z-drop
EXTZ = {"single": (2, 4, 4, 2, 4, 2), "wrap": (2, 4, 61, 2, 61, 2)}


def _extz_on_card(dev, profile, flag, seed=7, B=24):
    qpool, tpool, jobs, eb = _batch(seed, B=B)
    if profile == "wrap":
        jobs[:, 7] = -1
    return _extz_with(dev, qpool, tpool, jobs, profile, flag, eb)


def _extz_with(dev, qpool, tpool, jobs, profile, flag, eb):
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
    monkeypatch.setattr(K, "EXT_VARIANTS", {})
    monkeypatch.setattr(K, "EXT_SMEM_MAX", 0)
    c = _extz_on_card(cuda, "single", flag, 11, B=12)
    assert c.ext.path == "mem-global"
    _check_kernels_against_plain(c)


# every launch K1's and K4's geometry can choose: 128 threads x 1-8 slots,
# and the memory path (slot state in shared memory or global scratch) at
# 512 threads; the job lengths and band widths whose span takes each ring
# (128 x slots lanes; 512 for the memory path, forced), with targets
# longer than the ring
EXT_LAUNCHES = [(nt, spt) for nt, spts in sorted(K.EXT_VARIANTS.items())
                for spt in spts] + [(K.EXT_MEM_THREADS, 0, "smem"),
                                    (K.EXT_MEM_THREADS, 0, "global")]
EXT_LAUNCH_JOBS = {1: ((150, 320), (33, 64)), 2: ((300, 520), (97, 150)),
                   3: ((450, 700), (220, 300)), 4: ((550, 800), (350, 440)),
                   5: ((700, 1000), (480, 560)), 6: ((850, 1100), (600, 700)),
                   7: ((1000, 1250), (730, 820)),
                   8: ((1100, 1400), (860, 950)), 0: ((560, 800), (97, 150))}


@pytest.mark.parametrize("flag", (0x18, 0xC2), ids=lambda f: f"flag{f:#04x}")
@pytest.mark.parametrize("profile", ("map-ont", "wrap"))
@pytest.mark.parametrize("launch", EXT_LAUNCHES,
                         ids=lambda v: "-".join(map(str, v)))
def test_ext_kernel_launches_match_plain(cuda, launch, profile, flag,
                                         monkeypatch):
    """K1 (map-ont) and K4 (the wrap profile) at each launch they can
    take, on jobs whose targets are longer than the ring (the band wraps
    it), against the plain versions; the memory path is forced on a ring
    of 512 lanes."""
    nt, spt = launch[:2]
    if spt == 0:
        monkeypatch.setattr(K, "EXT_VARIANTS", {})
        if launch[2] == "global":
            monkeypatch.setattr(K, "EXT_SMEM_MAX", 0)
    (lo, hi), ws = EXT_LAUNCH_JOBS[spt]
    rng = np.random.default_rng(nt + spt)
    qpool, tpool, jobs, _, _ = check.random_jobs(
        rng, rng.integers(lo, hi, 7), rng.choice(ws, 8),
        -1 if profile == "wrap" else 200, dissimilar=True)
    eb = rng.integers(0, 60, 8)
    if profile == "wrap":
        c = _extz_with(cuda, qpool, tpool, jobs, "wrap", flag, eb)
    else:
        c = _on_card(cuda, qpool, tpool, jobs, profile, flag, eb)
    g = c.ext
    assert (g.threads, g.spt) == (nt, spt)
    assert g.ring >= c.geo.span and (c.jobs_np[:, 4] > g.ring).any()
    if spt == 0:
        assert g.mem_smem == (launch[2] == "smem")
    _check_kernels_against_plain(c)


def test_long_full_band_extz_job_matches_native(cuda):
    """One single-cost job whose full band needs K4's memory path with its
    slot state in global scratch, against native.extz."""
    rng = np.random.default_rng(5)
    t = rng.integers(0, 4, 16800).astype(np.uint8)
    q = check.mutate(rng, t, 0.08)
    mat = gen_simple_mat(2, 4, 1)
    mi = MinimizerIndex(w=10, k=15, codes=t)
    pools = K.PoolContext(q, mi, cuda)
    jobs = np.array([[0, len(q), 0, 0, len(t), 0, -1, 400]], np.int64)
    geo = K.job_geometry(jobs)
    assert K.ext_geometry(geo.span, geo.qlen_max).path == "mem-global"
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


@pytest.mark.parametrize("dirs_mode", ["u8", "i32"])
def test_probe_core_kernel_matches_plain_at_every_width(cuda, dirs_mode):
    """P3 level 6 at every Wb from 1 to 640: partial last chunks and
    4-lane groups."""
    assert PC.check_widths(cuda, PC.WIDTHS, dirs_mode) == 0


@pytest.mark.parametrize("dirs_mode", ["u8", "i32"])
def test_probe_core_kernel_matches_plain_at_wide_widths(cuda, dirs_mode):
    """P3 level 6 through the wide launch: Wb 641, 1000, 2048, 4096 and
    5000 (warps taking two chunks in turn)."""
    assert PC.check_widths(cuda, PC.WIDE_WIDTHS, dirs_mode) == 0


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


# C1 (csrc/chain.cu) and S1 (csrc/sketch.cu)

CHAIN_P = dict(max_dist_x=5000, min_dist_x=1000, max_dist_y=5000, bw=500,
               max_skip=25, max_iter=5000, min_cnt=3, min_sc=40,
               gap_scale=1.0, is_cdna=0)
CHAIN_CASES = {"dna": CHAIN_P,
               "cdna": dict(CHAIN_P, is_cdna=1, gap_scale=0.8, bw=2000,
                            max_dist_x=16000, max_dist_y=16000),
               "skip1": dict(CHAIN_P, max_skip=1),
               "wide": CHAIN_P}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_kernel_matches_plain(cuda, case):
    """C1 == its plain version (f, pre, v) in one launch, and chained to the
    end == native.chain_dp: random and repeat-rich sets and a single anchor
    (dna), cDNA's gap cost with stage-2 gaps at gap scale 0.8, the same
    sets at max_skip 1 (the break cuts walks short), and a repeat cluster
    whose windows pass 8192 (wide)."""
    from winnowmap_tpu_torch.chain import device as CD
    from winnowmap_tpu_torch.chain.check import anchor_set

    p = CHAIN_CASES[case]
    rng = np.random.default_rng(len(case))
    if case == "wide":
        jobs = [anchor_set(rng, 8400, repeat=True, n_clusters=1),
                anchor_set(rng, 3000)]
    else:
        jobs = [anchor_set(rng, int(rng.integers(100, 4000)),
                           repeat=(t % 3 == 0)) for t in range(12)]
        jobs.append((jobs[0][0][:1], jobs[0][1][:1]))
    cj = CD.chain_jobs(jobs, p["max_dist_x"], p["min_dist_x"],
                       p["max_iter"], cuda)
    args = (p["max_dist_x"], p["max_dist_y"], p["bw"], p["max_skip"],
            p["is_cdna"], float(np.float32(p["gap_scale"])))
    n0 = CD.LAUNCHES["chain_fwd"]
    kern = CD.chain_fwd(cj, *args)
    assert CD.LAUNCHES["chain_fwd"] == n0 + 1
    assert torch.equal(kern, CD.chain_fwd_plain(cj, *args))
    res = CD.chain_dp_device_batch(
        jobs, p["max_dist_x"], p["min_dist_x"], p["max_dist_y"], p["bw"],
        p["max_skip"], p["max_iter"], p["min_cnt"], p["min_sc"],
        p["gap_scale"], p["is_cdna"], cuda)
    for (ax, ay), got in zip(jobs, res):
        want = native.chain_dp(ax, ay, n_segs=1, **p)
        assert all(np.array_equal(a, b) for a, b in zip(want, got))


# asm5's stage-2 chain parameters (max gap 16000, bw 2000)
CHAIN_P2 = dict(CHAIN_P, max_dist_x=16000, max_dist_y=16000, bw=2000)


@pytest.mark.parametrize("case", ["wide", "gapped", "gapped-long"])
def test_chain_kernel_stage2_past_the_ring(cuda, case):
    """C1 == its plain version and, chained to the end, == native.chain_dp
    under stage-2 parameters on chain.check's sets whose walks leave C1's
    shared-memory ring: chain_sets' repeat cluster of 9,000 anchors
    (windows past 8192), gapped_set (a predecessor taken and marks read
    past RING_REACH) and its long form at max_skip 103 (the walk breaks
    one mark short of a better predecessor, after three steps of 64)."""
    from winnowmap_tpu_torch.chain import device as CD
    from winnowmap_tpu_torch.chain.check import chain_sets, gapped_set

    p = CHAIN_P2
    if case == "gapped-long":
        jobs = [gapped_set(np.random.default_rng(41), 1099, 150)]
        p = dict(CHAIN_P2, max_skip=103)
    else:
        jobs = [chain_sets()[-2 if case == "wide" else -1]]
    cj = CD.chain_jobs(jobs, p["max_dist_x"], p["min_dist_x"],
                       p["max_iter"], cuda)
    local = (torch.arange(cj.x.numel(), device=cuda)
             - torch.repeat_interleave(cj.off[:-1], cj.off.diff()))
    assert int((local - cj.st).max()) > (8192 if case == "wide"
                                         else CD.RING_REACH)
    args = (p["max_dist_x"], p["max_dist_y"], p["bw"], p["max_skip"],
            p["is_cdna"], float(np.float32(p["gap_scale"])))
    kern = CD.chain_fwd(cj, *args)
    plain = CD.chain_fwd_plain(cj, *args)
    assert torch.equal(kern, plain)
    if case != "wide":
        has = plain[1] >= 0
        assert int((local - plain[1])[has].max()) > CD.RING_REACH
    res = CD.chain_dp_device_batch(
        jobs, p["max_dist_x"], p["min_dist_x"], p["max_dist_y"], p["bw"],
        p["max_skip"], p["max_iter"], p["min_cnt"], p["min_sc"],
        p["gap_scale"], p["is_cdna"], cuda)
    for (ax, ay), got in zip(jobs, res):
        want = native.chain_dp(ax, ay, n_segs=1, **p)
        assert all(np.array_equal(a, b) for a, b in zip(want, got))


@pytest.mark.parametrize("case", ["stage 2", "skip1"])
def test_chain_kernel_short_chains(cuda, case):
    """C1 on chain.check's short_sets (1-12 anchors, and lengths that are
    not multiples of 8), where a chain ends inside the walking warp's wait
    for the producer warps' next anchors: 200 launches of the same jobs,
    each == the plain version (a read of an anchor the producers have not
    scored yet shows only under some timings), under stage-2 parameters
    and at max_skip 1; and each set chained to the end ==
    native.chain_dp."""
    from winnowmap_tpu_torch.chain import device as CD
    from winnowmap_tpu_torch.chain.check import short_sets

    p = CHAIN_P2 if case == "stage 2" else dict(CHAIN_P2, max_skip=1)
    jobs = short_sets(np.random.default_rng(len(case)))
    cj = CD.chain_jobs(jobs, p["max_dist_x"], p["min_dist_x"],
                       p["max_iter"], cuda)
    args = (p["max_dist_x"], p["max_dist_y"], p["bw"], p["max_skip"],
            p["is_cdna"], float(np.float32(p["gap_scale"])))
    plain = CD.chain_fwd_plain(cj, *args)
    runs = [CD.chain_fwd(cj, *args) for _ in range(200)]
    assert all(torch.equal(r, plain) for r in runs)
    res = CD.chain_dp_device_batch(
        jobs, p["max_dist_x"], p["min_dist_x"], p["max_dist_y"], p["bw"],
        p["max_skip"], p["max_iter"], p["min_cnt"], p["min_sc"],
        p["gap_scale"], p["is_cdna"], cuda)
    for (ax, ay), got in zip(jobs, res):
        want = native.chain_dp(ax, ay, n_segs=1, **p)
        assert all(np.array_equal(a, b) for a, b in zip(want, got))


@pytest.mark.parametrize("k", [1, 15, 19, 28])
def test_sketch_kernel_matches_plain(cuda, k):
    """S1 == its plain version on 200,001 codes with ambiguous bases (a
    partial last stretch), every output (the order's bits), one launch a
    call: with no set, a sorted set of 3,000 canonical k-mers and its
    bloom table."""
    from winnowmap_tpu_torch.index.build import weight_bloom
    from winnowmap_tpu_torch.sketch import device as SD

    rng = np.random.default_rng(k)
    codes = torch.from_numpy(rng.integers(0, 5, 200_001).astype(
        np.uint8)).to(cuda)
    canon = SD.transform_plain(codes, k)[4].cpu().numpy().view(np.uint64)
    ws = np.unique(rng.choice(canon, 3000))
    for wset, bl in ((None, None), (ws, None), (None, weight_bloom(ws))):
        wt = SD.weights_on(wset, bl, cuda)
        n0 = SD.LAUNCHES["sketch"]
        kern = SD.sketch(codes, k, wt)
        assert SD.LAUNCHES["sketch"] == n0 + 1
        for a, b in zip(kern, SD.sketch_plain(codes, k, wt)):
            assert a.dtype == b.dtype
            if a.dtype == torch.float64:
                a, b = a.view(torch.int64), b.view(torch.int64)
            assert torch.equal(a, b)


@pytest.mark.parametrize("hpc", [False, True], ids=["plain", "hpc"])
def test_sketch_device_on_card_matches_native(cuda, hpc):
    """sketch_device with S1 on the card == native.sketch: N bases, lower
    case, a weighted set of every 37th k-mer."""
    from winnowmap_tpu_torch.sketch import device as SD

    rng = np.random.default_rng(23)
    seq = rng.choice(list(b"ACGTacgtN"), 60_000,
                     p=[.22, .22, .22, .22, .02, .02, .02, .02, .04]
                     ).astype(np.uint8).tobytes()
    ws = np.unique(np.array([native.encode_kmer(seq[o:o + 15].upper())
                             for o in range(0, len(seq) - 15, 37)
                             if b"N" not in seq[o:o + 15]], np.uint64))
    want = native.sketch(seq, 50, 15, 2, hpc, ws)
    got = SD.sketch_device(seq, 50, 15, 2, hpc, ws, device=cuda)
    assert all(np.array_equal(a, b) for a, b in zip(want, got))


def test_build_index_on_card_matches_native(cuda):
    """A 1 Mbp genome in two sequences: the index built through S1 (the
    default device) == the native build, one S1 launch for both."""
    from winnowmap_tpu_torch.index import build
    from winnowmap_tpu_torch.io.fastx import SeqRecord
    from winnowmap_tpu_torch.sketch import device as SD

    g = np.random.default_rng(9).choice(list(b"ACGT"), 1_000_000).astype(
        np.uint8).tobytes()
    recs = [SeqRecord("c1", g[:600_000], None, None),
            SeqRecord("c2", g[600_000:], None, None)]
    n0 = SD.LAUNCHES["sketch"]
    dev = build.build_index(recs, 10, 15)
    assert SD.LAUNCHES["sketch"] == n0 + 1
    host = build.build_index(recs, 10, 15, sketch_min_bp=None)
    for f in ("keys", "start", "pos", "codes"):
        assert np.array_equal(getattr(dev, f), getattr(host, f)), f


def test_chain_exchange_on_card_matches_host(cuda):
    """The engine with every chain through its exchange onto C1 (chain_min
    1) == every chain on its scalar DP, on the card; and likewise the
    generator path, every chain through chain_dp_auto onto C1."""
    from test_torch_chain import _corpus, _port_index
    from test_torch_engine import assert_same_results

    from winnowmap_tpu_torch.chain import device as CD
    from winnowmap_tpu_torch.map import batch
    from winnowmap_tpu_torch.map.engine import STATS, map_batch_engine

    gstr, reads, names = _corpus()
    mi, mo = _port_index(gstr)
    host = map_batch_engine(mi, mo, reads, names, cuda, chain_min=0)
    n0 = CD.LAUNCHES["chain_fwd"]
    STATS.clear()
    got = map_batch_engine(mi, mo, reads, names, cuda, chain_min=1)
    assert STATS["chain_dev_jobs"] > 0
    assert CD.LAUNCHES["chain_fwd"] > n0
    assert_same_results(host, got)
    gen_host = batch.map_batch_generator(mi, mo, reads, names, cuda,
                                         chain_min=0)
    n0 = CD.LAUNCHES["chain_fwd"]
    gen = batch.map_batch_generator(mi, mo, reads, names, cuda, chain_min=1)
    assert CD.LAUNCHES["chain_fwd"] > n0
    assert_same_results(gen_host, gen)


# KC (csrc/kcount.cu)


@pytest.mark.parametrize("direction", ["canonical", "forward", "reverse"])
@pytest.mark.parametrize("k", [1, 15, 19, 31, 32])
def test_kcount_kernel_matches_plain(cuda, k, direction):
    """KC == its plain version on 300,001 codes with N runs and a poly-G
    stretch (74 tiles, the last partial), in one launch; and on a poly-G
    block, whose all-ones k-mer at k = 32 forward KC counts."""
    from winnowmap_tpu_torch.kcount import device as KD

    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 300_001).astype(np.uint8)
    for at in rng.integers(0, 299_000, 40):
        codes[at:at + int(rng.integers(1, 200))] = 255
    codes[5000:9000] = 3
    for c in (codes, np.full(5000, 3, np.uint8)):
        t = torch.from_numpy(c).to(cuda)
        n0 = KD.LAUNCHES["kcount"]
        km, ct = KD.count_block(t, k, direction)
        assert KD.LAUNCHES["kcount"] == n0 + 1
        pk, pc = KD.count_block_plain(t, k, direction)
        assert torch.equal(km, pk) and torch.equal(ct, pc)


@pytest.mark.parametrize("k", [15, 19], ids=["u32", "u64"])
def test_kcount_kernel_full_block_matches_plain(cuda, k):
    """KC == its plain version on a full block of BLOCK (4 Mi) codes with N
    runs and a poly-G stretch (1,024 tiles: long look-back chains on the
    card), u32 keys at k = 15 and u64 at k = 19, canonical."""
    from winnowmap_tpu_torch.kcount import device as KD

    rng = np.random.default_rng(4 + k)
    codes = rng.integers(0, 4, KD.BLOCK).astype(np.uint8)
    for at in rng.integers(0, KD.BLOCK - 200, 40):
        codes[at:at + int(rng.integers(1, 200))] = 255
    codes[1 << 20:(1 << 20) + 20_000] = 3
    t = torch.from_numpy(codes).to(cuda)
    km, ct = KD.count_block(t, k)
    pk, pc = KD.count_block_plain(t, k)
    assert torch.equal(km, pk) and torch.equal(ct, pc)


def test_count_kmers_on_card_matches_host(cuda, monkeypatch):
    """The golden genome counted through KC in blocks of 65,536 codes (the
    runs merged on the host), each direction: the host counter's set."""
    from winnowmap_tpu_torch import kcount
    from winnowmap_tpu_torch.io.fastx import read_all
    from winnowmap_tpu_torch.kcount import device as KD
    from winnowmap_tpu_torch.kcount.outofcore import count_kmers_chunked

    monkeypatch.setattr(KD, "BLOCK", 1 << 16)
    recs = read_all(str(GOLD / "t_ref.fa"))
    for direction in ("canonical", "forward", "reverse"):
        n0 = KD.LAUNCHES["kcount"]
        got = kcount.count_kmers(recs, 15, direction=direction)
        assert KD.LAUNCHES["kcount"] > n0 + 1
        want = count_kmers_chunked(recs, 15, direction=direction)
        assert np.array_equal(got.kmers, want.kmers)
        assert np.array_equal(got.counts, want.counts)


def test_meryl_cli_on_card_matches_goldens(cuda, tmp_path, capsys):
    """meryl count on the card, then print and print greater-than
    distinct=0.9998: the reference meryl's goldens."""
    import hashlib

    from winnowmap_tpu_torch.meryl_cli import main

    db = str(tmp_path / "db")
    assert main(["count", "k=15", "output", db,
                 str(GOLD / "t_ref.fa")]) == 0
    capsys.readouterr()
    assert main(["print", db]) == 0
    out = capsys.readouterr().out
    assert hashlib.md5(out.encode()).hexdigest() == \
        (GOLD / "golden_meryl_print.md5").read_text().strip()
    assert main(["print", "greater-than", "distinct=0.9998", db]) == 0
    assert capsys.readouterr().out == \
        (GOLD / "golden_meryl_rep_distinct9998.txt").read_text()
