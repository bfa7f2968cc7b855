"""Pieces of the port's generator mapping path on the CPU: read_bed and
bed_junc against the JAX package's, PoolContext.resolve,
DevCallPooled.collect() against native.ExtResult field by field (the plain
versions of the kernels, z-dropped and extz-only reach_end jobs included),
and run_ext_tasks on a job list split across calls and on refused jobs.
Every comparison is exact."""
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from winnowmap_tpu_torch import native
from winnowmap_tpu_torch.extend import check
from winnowmap_tpu_torch.extend.kernels import DevCallPooled, PoolContext
from winnowmap_tpu_torch.index.build import MinimizerIndex, SeqMeta
from winnowmap_tpu_torch.map.align import gen_simple_mat
from winnowmap_tpu_torch.options import MapOptions

torch.set_num_threads(1)

GOLD = Path(__file__).resolve().parent / "data" / "golden"
CPU = torch.device("cpu")

BED = ("chrS\t100\t200\tj1\t0\t+\n"
       "chrS\t300\t400\tj2\t0\t-\n"
       "chrS\t1000\t2000\ttx\t0\t+\t1000\t2000\t0\t2\t100,100,\t0,900,\n"
       "chrS\t2500\t2600\tj3\t0\t.\n"
       "chrX\t10\t20\tother\t0\t+\n")


def _bed_file(tmp_path):
    p = tmp_path / "a.bed"
    p.write_text(BED)
    return str(p)


def test_bed_junction_flags(tmp_path):
    """read_bed/bed_junc unit semantics (reference mm_idx_read_bed +
    mm_idx_bed_junc, src/index.c:690-803), as tests/test_e2e.py checks the
    JAX package's."""
    from winnowmap_tpu_torch.index.build import bed_junc, read_bed

    mi = MinimizerIndex(w=50, k=15)
    mi.seqs.append(SeqMeta("chrS", 0, 60000))
    read_bed(mi, _bed_file(tmp_path), read_junc=True)
    j = bed_junc(mi, 0, 0, 3000)
    assert j[100] & 1 and j[199] & 2      # + strand: donor at st, acceptor
    assert j[300] & 8 and j[399] & 4      # - strand bits
    assert j[1100] & 1 and j[1899] & 2    # BED12 intron = between blocks
    assert int(j.sum()) == 1 + 2 + 8 + 4 + 1 + 2  # no strand: no bits
    j2 = bed_junc(mi, 0, 150, 3000)       # j1 is not wholly inside
    assert not j2[:50].any() and j2[1100 - 150] & 1


@pytest.mark.parametrize("window", [(0, 3000), (150, 1950), (1000, 2000),
                                    (5000, 6000)])
def test_bed_junc_matches_jax(tmp_path, window):
    from winnowmap_tpu.index.build import MinimizerIndex as JMI
    from winnowmap_tpu.index.build import SeqMeta as JSM
    from winnowmap_tpu.index.build import bed_junc as jbed_junc
    from winnowmap_tpu.index.build import read_bed as jread_bed
    from winnowmap_tpu_torch.index.build import bed_junc, read_bed

    path = _bed_file(tmp_path)
    jmi = JMI(w=50, k=15)
    jmi.seqs.append(JSM("chrS", 0, 60000))
    jread_bed(jmi, path, read_junc=True)
    mi = MinimizerIndex(w=50, k=15)
    mi.seqs.append(SeqMeta("chrS", 0, 60000))
    read_bed(mi, path, read_junc=True)
    assert mi.intervals.keys() == jmi.intervals.keys()
    for rid in mi.intervals:
        for a, b in zip(mi.intervals[rid], jmi.intervals[rid]):
            assert np.array_equal(a, b)
    assert np.array_equal(bed_junc(mi, 0, *window),
                          jbed_junc(jmi, 0, *window))


def test_splice_corpus_bed_matches_jax():
    """s_junc.bed on the splice corpus's reference: the same intervals and
    the same junction bytes over every 2 kb window."""
    from winnowmap_tpu.index.build import bed_junc as jbed_junc
    from winnowmap_tpu.index.build import build_index as jbuild
    from winnowmap_tpu.index.build import read_bed as jread_bed
    from winnowmap_tpu.io.fastx import read_all as jread_all
    from winnowmap_tpu_torch.index.build import (bed_junc, build_index,
                                                 read_bed)
    from winnowmap_tpu_torch.io.fastx import read_all

    jmi = jbuild(jread_all(str(GOLD / "s_ref.fa")), 10, 15)
    jread_bed(jmi, str(GOLD / "s_junc.bed"))
    mi = build_index(read_all(str(GOLD / "s_ref.fa")), 10, 15)
    read_bed(mi, str(GOLD / "s_junc.bed"))
    assert mi.intervals and mi.intervals.keys() == jmi.intervals.keys()
    n_bits = 0
    for rid, s in enumerate(mi.seqs):
        for st in range(0, s.length, 2000):
            en = min(s.length, st + 2000)
            j = bed_junc(mi, rid, st, en)
            assert np.array_equal(j, jbed_junc(jmi, rid, st, en))
            n_bits += int((j != 0).sum())
    assert n_bits > 0


def test_pool_resolve():
    from winnowmap_tpu_torch.map.align import JobSeq

    qpool = np.arange(64, dtype=np.uint8) % 5
    mi = MinimizerIndex(w=10, k=15, codes=np.zeros(100, np.uint8))
    pools = PoolContext(qpool, mi, CPU)
    assert pools.resolve(JobSeq(qpool[5:20])) == (0, 5)
    assert pools.resolve(JobSeq(mi.codes[30:40], rev=True)) == (1, 30)
    assert pools.resolve(JobSeq(qpool[5:20].copy())) is None
    assert pools.resolve(JobSeq(qpool[5:20:2])) is None


# (a, b, q, e, q2, e2): map-ont (extd) and one gap cost (extz)
EXTD, EXTZ = (2, 4, 4, 2, 24, 1), (2, 4, 4, 2, 4, 2)


@pytest.mark.parametrize("flag", [0x0, 0x40, 0xC2, 0x18, 0x01],
                         ids=lambda f: f"flag{f:#04x}")
@pytest.mark.parametrize("prof", ["extd", "extz"])
def test_collect_matches_native(prof, flag):
    """collect() against native.extd/extz on every job: the nine result
    fields, zdropped, reach_end and the CIGAR.  Small z-drops and an
    unrelated pair make some jobs z-drop; end bonuses up to 60 make
    extz-only jobs reach the end."""
    a, b, q, e, q2, e2 = EXTD if prof == "extd" else EXTZ
    rng = np.random.default_rng(5 + flag)
    B = 14
    qp, tp, jobs, qs, ts = check.random_jobs(
        rng, rng.integers(30, 260, B - 1), rng.choice([33, 97, -1], B),
        rng.choice([20, 40, 400], B), dissimilar=True, err=0.15)
    eb = rng.integers(0, 60, B)
    mat = gen_simple_mat(a, b, 1)
    mi = MinimizerIndex(w=10, k=15, codes=tp)
    call = DevCallPooled(PoolContext(qp, mi, CPU), jobs, mat, q, e, q2, e2,
                         eb, flag)
    got = call.collect()
    assert len(got) == B
    n_zd = n_reach = 0
    for i, r in enumerate(got):
        qq = qs[i][::-1] if jobs[i, 2] else qs[i]
        tt = ts[i][::-1] if jobs[i, 5] else ts[i]
        w, zd = int(jobs[i, 6]), int(jobs[i, 7])
        if prof == "extd":
            h = native.extd(qq, tt, mat, q, e, q2, e2, w, zd, int(eb[i]), flag)
        else:
            h = native.extz(qq, tt, mat, q, e, w, zd, int(eb[i]), flag)
        assert isinstance(r, native.ExtResult)
        for f in native.ExtResult.__slots__:
            if f == "cigar":
                assert np.array_equal(r.cigar, h.cigar), (i, f)
            else:
                assert getattr(r, f) == getattr(h, f), (i, f)
        n_zd += h.zdropped
        n_reach += h.reach_end
    if flag & 0x40 and not flag & 0x01:
        assert n_reach > 0
    assert n_zd > 0


@pytest.mark.parametrize("flag", [0x508, 0x5C2], ids=lambda f: f"flag{f:#05x}")
def test_collect_spliced_matches_native(flag):
    """collect() of an exts call with junction bytes on a third of the
    jobs against native.exts (reach_end stays False, as wm_exts leaves
    it)."""
    a, b, q, e, q2, noncan, jb = 1, 2, 2, 1, 32, 9, 9
    rng = np.random.default_rng(11)
    B = 8
    qp, tp, jobs, qs, ts, js = check.spliced_jobs(
        rng, B, rev=bool(flag & 0x80), exon_total=(120, 260),
        intron_len=(40, 120))
    mat = gen_simple_mat(a, b, 1)
    mi = MinimizerIndex(w=10, k=15, codes=tp)
    got = DevCallPooled(PoolContext(qp, mi, CPU), jobs, mat, q, e, q2, 0, 0,
                        flag, splice=(noncan, jb), juncs=js).collect()
    assert any(j is not None for j in js)
    for i, r in enumerate(got):
        h = native.exts(qs[i], ts[i], mat, q, e, q2, noncan, int(jobs[i, 7]),
                        jb, flag, junc=js[i])
        for f in native.ExtResult.__slots__:
            if f == "cigar":
                assert np.array_equal(r.cigar, h.cigar), (i, f)
            else:
                assert getattr(r, f) == getattr(h, f), (i, f)


def _gen_list(opt, mi, qp, pools_jobs, flags):
    """A generator that yields one list of jobs (one per row, the given
    flags) and returns what it got back."""
    from winnowmap_tpu_torch.map.align import JobSeq

    mat = gen_simple_mat(opt.a, opt.b, opt.sc_ambi)
    jobs = []
    for row, flag in zip(pools_jobs, flags):
        qo, ql, qr, to, tl, tr, w, zd = (int(x) for x in row)
        jobs.append((opt, JobSeq(qp[qo:qo + ql], bool(qr)),
                     JobSeq(mi.codes[to:to + tl], bool(tr)), mat, w,
                     opt.end_bonus, zd, flag))
    got = yield jobs
    return got


def test_job_list_split_across_calls(monkeypatch):
    """One yielded list whose jobs land in three calls (two flags, and the
    larger group split by a small MAX_CALL_DIRS_BYTES) gets its results
    back as a list in the yielded order, each equal to native.extd."""
    from winnowmap_tpu_torch.map import batch

    opt = MapOptions()
    rng = np.random.default_rng(3)
    B = 9
    qp, tp, jobs, qs, ts = check.random_jobs(rng, rng.integers(40, 200, B),
                                             97, 400)
    mi = MinimizerIndex(w=10, k=15, codes=tp)
    pools = PoolContext(qp, mi, CPU)
    flags = [0x0 if i % 3 else 0x40 for i in range(B)]
    nb = check.OnDevice("cpu", qp, tp, jobs, gen_simple_mat(2, 4, 1),
                        (4, 2, 24, 1), 0, 0).geo.nbytes
    monkeypatch.setattr(batch, "MAX_CALL_DIRS_BYTES", int(nb.max()))
    batch.STATS.clear()
    t = batch._Task(_gen_list(opt, mi, qp, jobs, flags))
    batch.run_ext_tasks([t], pools)
    assert batch.STATS["dev_calls"] >= 3
    assert batch.STATS["dev_jobs"] == B and batch.STATS["host_jobs"] == 0
    mat = gen_simple_mat(opt.a, opt.b, opt.sc_ambi)
    assert t.done and len(t.value) == B
    for i, r in enumerate(t.value):
        qq = qs[i][::-1] if jobs[i, 2] else qs[i]
        tt = ts[i][::-1] if jobs[i, 5] else ts[i]
        h = native.extd(qq, tt, mat, opt.q, opt.e, opt.q2, opt.e2, 97, 400,
                        opt.end_bonus, flags[i])
        assert (r.max, r.score, r.max_q, r.max_t, r.reach_end) == \
            (h.max, h.score, h.max_q, h.max_t, h.reach_end), i
        assert np.array_equal(r.cigar, h.cigar), i


def test_refused_jobs_stay_on_the_host():
    """--cap-sw-mem's dummy drop is the one host result of this list; the
    other jobs go to the device, and align_pair refuses them."""
    from winnowmap_tpu_torch.map import batch
    from winnowmap_tpu_torch.map.align import JobSeq, align_pair, refused

    opt = replace(MapOptions(), max_sw_mat=150 * 150)
    rng = np.random.default_rng(4)
    qp, tp, jobs, _, _ = check.random_jobs(rng, [100, 120, 400], 97, 400)
    mi = MinimizerIndex(w=10, k=15, codes=tp)
    assert [refused(opt, int(j[1]), int(j[4])) for j in jobs] == \
        [False, False, True]
    batch.STATS.clear()
    t = batch._Task(_gen_list(opt, mi, qp, jobs, [0x0] * 3))
    batch.run_ext_tasks([t], PoolContext(qp, mi, CPU))
    assert batch.STATS["host_jobs"] == 1 and batch.STATS["dev_jobs"] == 2
    r = t.value[2]
    assert r.zdropped and r.max == 0 and len(r.cigar) == 0
    assert t.value[0].score > 0
    mat = gen_simple_mat(opt.a, opt.b, opt.sc_ambi)
    with pytest.raises(ValueError, match="device"):
        align_pair(opt, JobSeq(qp[:100]), JobSeq(tp[:100]), mat, 97, 0, 400,
                   0)
