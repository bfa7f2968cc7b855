"""Multi-part indexes in the port (-I, --split-prefix:
winnowmap_tpu_torch/map/pipeline.map_file_multipart and its helpers)
against the JAX package: split_parts_by_bp, merge_read_regs and the hit
files' pack_results/unpack_results equal winnowmap_tpu's on seeded
inputs, and the port CLI's -I output on the first reads of t_reads.fa is
byte-equal to the JAX CLI's on its host kernels (WM_NO_TPU=1): at 100k
(t_ref.fa's two chromosomes of ~100 kb each, under 100 kb: the first part
takes both, so one part on the multi-part path) and at 50k (a part a
chromosome, merged).  All comparisons are exact."""
import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLD = REPO / "tests" / "data" / "golden"
N_READS = 3


@pytest.fixture(scope="module")
def reads_fa(tmp_path_factory):
    recs = (GOLD / "t_reads.fa").read_text().split(">")[1:N_READS + 1]
    p = tmp_path_factory.mktemp("mp") / "reads.fa"
    p.write_text("".join(">" + r for r in recs))
    return p


def _out(fn, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(list(argv), **kw)
    assert rc == 0
    return buf.getvalue()


def test_split_parts_by_bp_matches_jax():
    from winnowmap_tpu.io.fastx import SeqRecord
    from winnowmap_tpu.map.pipeline import split_parts_by_bp as jax_split
    from winnowmap_tpu_torch.map.pipeline import split_parts_by_bp

    rng = np.random.default_rng(20261018)
    recs = [SeqRecord(f"r{i}", b"A" * int(n), None, None)
            for i, n in enumerate(rng.integers(0, 5000, 60))]
    for bp in (1, 999, 4000, 20_000, 10**9):
        got = [[r.name for r in p] for p in split_parts_by_bp(recs, bp)]
        assert got == [[r.name for r in p] for p in jax_split(recs, bp)]


def _regs(mod, rng, n, rid_hi):
    """n seeded regions of the hit module `mod` (the port's or the JAX
    package's Reg and Extra), with CIGARs and random ties."""
    regs = []
    for i in range(n):
        r = mod.Reg(id=i, parent=i, rid=int(rng.integers(0, rid_hi)),
                    score=int(rng.integers(20, 400)),
                    qs=int(rng.integers(0, 500)), rs=int(rng.integers(0,
                                                                      9000)),
                    rev=bool(rng.integers(0, 2)),
                    hash=int(rng.integers(0, 1 << 32)),
                    cnt=int(rng.integers(1, 50)), div=float(rng.random()))
        r.qe = r.qs + int(rng.integers(50, 2000))
        r.re = r.rs + int(rng.integers(50, 2000))
        r.mlen = r.blen = int(rng.integers(30, 1500))
        r.score0 = r.score
        r.p = mod.Extra(dp_max=int(rng.integers(10, 3000)),
                        dp_max2=int(rng.integers(0, 10)),
                        dp_score=int(rng.integers(10, 3000)))
        r.p.cigar = rng.integers(1, 1 << 12, int(rng.integers(1, 6))
                                 ).astype(np.uint32)
        regs.append(r)
    return regs


def _fields(regs):
    return [(r.id, r.parent, r.rid, r.score, r.qs, r.qe, r.rs, r.re,
             r.mapq, r.sam_pri, r.subsc, r.n_sub, r.rev, r.hash,
             None if r.p is None else (r.p.dp_max, r.p.cigar.tolist()))
            for r in regs]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_merge_read_regs_matches_jax(seed):
    """One read's regions from three parts (rids shifted) merged: the
    union's order, parents, primaries, MAPQ and rep_len equal the JAX
    package's merge_read_regs."""
    from winnowmap_tpu.map import hit as jhit
    from winnowmap_tpu.map.pipeline import merge_read_regs as jax_merge
    from winnowmap_tpu.options import MapOptions as JOpt
    from winnowmap_tpu_torch.map import hit as phit
    from winnowmap_tpu_torch.map.pipeline import merge_read_regs
    from winnowmap_tpu_torch.options import MapOptions as POpt

    parts_j, parts_p = [], []
    for pi in range(3):
        n = int(np.random.default_rng(seed * 10 + pi).integers(0, 7))
        parts_j.append(_regs(jhit, np.random.default_rng(seed * 10 + pi),
                             n, 4))
        parts_p.append(_regs(phit, np.random.default_rng(seed * 10 + pi),
                             n, 4))
    reps = [int(v) for v in np.random.default_rng(seed).integers(0, 900, 3)]
    rj, lj = jax_merge(JOpt(), 15, parts_j, reps)
    rp, lp = merge_read_regs(POpt(), 15, parts_p, reps)
    assert lp == lj
    assert _fields(rp) == _fields(rj)


def test_pack_results_matches_jax():
    """A part's hit-file rows: pack_results gives the JAX package's arrays
    (parallel/sharded.py), and unpack_results gives the regions back."""
    from winnowmap_tpu.map import hit as jhit
    from winnowmap_tpu.map.frag import MapResult as JRes
    from winnowmap_tpu.parallel.sharded import pack_results as jax_pack
    from winnowmap_tpu_torch.map import hit as phit
    from winnowmap_tpu_torch.map.frag import MapResult
    from winnowmap_tpu_torch.map.pipeline import pack_results, \
        unpack_results

    res_j = [JRes(_regs(jhit, np.random.default_rng(s), s % 4, 3), 40 + s,
                  0, bool(s % 2)) for s in range(6)]
    res_p = [MapResult(_regs(phit, np.random.default_rng(s), s % 4, 3),
                       40 + s, 0, bool(s % 2)) for s in range(6)]
    for a, b in zip(pack_results(res_p), jax_pack(res_j)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    back = unpack_results(*pack_results(res_p))
    for a, b in zip(back, res_p):
        assert (a.rep_len, a.rep_len_defined) == (b.rep_len,
                                                  b.rep_len_defined)
        assert _fields(a.regs) == _fields(b.regs)


@pytest.mark.parametrize("extra", [
    ["--sv-off", "-c", "-I", "100k"],
    ["--sv-off", "-c", "-I", "50k"],
    ["-a", "-I", "50k", "--split-prefix", "SPLIT"],
], ids=["I100k", "I50k", "split-prefix"])
def test_cli_multipart_matches_jax_cli(extra, reads_fa, tmp_path,
                                       monkeypatch):
    """-I 100k (one part) and 50k (two) with -c, and 50k with -a and
    --split-prefix (the hit files under the prefix's directory):
    byte-equal to the JAX CLI."""
    from winnowmap_tpu.cli import main as jax_main
    from winnowmap_tpu_torch.cli import main as port_main

    monkeypatch.setenv("WM_NO_TPU", "1")
    extra = [str(tmp_path / "sp" / "x") if a == "SPLIT" else a
             for a in extra]
    argv = extra + ["-W", str(GOLD / "t_rep_k15.txt"),
                    str(GOLD / "t_ref.fa"), str(reads_fa)]
    got = _out(port_main, argv, device="cpu")
    assert got == _out(jax_main, argv)
    assert sum(1 for ln in got.splitlines()
               if not ln.startswith("@")) >= N_READS


def test_map_file_multipart_parts_one_at_a_time(reads_fa, monkeypatch):
    """map_file_multipart at 50k: two parts, each built and mapped in turn
    (part 0's reads before part 1's build), part 1's rids shifted past
    part 0's record; each part's regions equal the JAX package's map_one
    against that part alone."""
    from winnowmap_tpu.index.build import build_index as jax_build
    from winnowmap_tpu.io.fastx import read_all as jax_read
    from winnowmap_tpu.map.frag import map_one as jax_map_one
    from winnowmap_tpu.options import IndexOptions as JIo
    from winnowmap_tpu.options import MapOptions as JOpt
    from winnowmap_tpu.options import update_mid_occ as jax_mid
    from winnowmap_tpu_torch.index.build import load_weight_set
    from winnowmap_tpu_torch.io.fastx import read_all
    from winnowmap_tpu_torch.map import pipeline
    from winnowmap_tpu_torch.options import IndexOptions, MapOptions

    monkeypatch.setenv("WM_NO_TPU", "1")
    io_, mo = IndexOptions(), MapOptions()
    mo.sv_aware = False
    wset = load_weight_set(str(GOLD / "t_rep_k15.txt"), io_.k)
    seen = []
    events = []
    build, map_batch = pipeline.build_index, pipeline.map_batch

    def built(recs, *a, **kw):
        events.append(("build", [r.name for r in recs]))
        return build(recs, *a, **kw)

    def mapped(mi, opt, seqs, names, **kw):
        res = map_batch(mi, opt, seqs, names, **kw)
        events.append(("map", [s.name for s in mi.seqs]))
        seen.append((len(seen), names, res))  # rids are shifted in place
        return res

    monkeypatch.setattr(pipeline, "build_index", built)
    monkeypatch.setattr(pipeline, "map_batch", mapped)
    n = pipeline.map_file_multipart(
        read_all(str(GOLD / "t_ref.fa")), io_, mo, wset, [str(reads_fa)],
        out=io.StringIO(), batch_bp=50_000, device="cpu")
    assert n == N_READS
    assert events == [("build", ["chr1"]), ("map", ["chr1"]),
                      ("build", ["chr2"]), ("map", ["chr2"])]
    jrecs = jax_read(str(GOLD / "t_ref.fa"))
    seqs = {r.split("\n", 1)[0].split()[0]: r.split("\n", 1)[1].replace(
        "\n", "").encode() for r in reads_fa.read_text().split(">")[1:]}
    for pi, names, res in seen:
        jmi = jax_build([jrecs[pi]], JIo().w, JIo().k, 0, np.asarray(wset))
        jo = JOpt()
        jo.sv_aware = False
        jax_mid(jo, jmi)
        want = []
        for name in names:
            want.append([(g.rid + pi, g.rs, g.re, g.qs, g.qe, g.rev, g.score)
                         for g in jax_map_one(jmi, jo, seqs[name],
                                              name).regs])
        assert [[(g.rid, g.rs, g.re, g.qs, g.qe, g.rev, g.score)
                 for g in x.regs] for x in res] == want
