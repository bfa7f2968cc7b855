"""The port's genome-scale run (winnowmap_tpu_torch/tools/scale_run.py)
against the JAX tool (tests/tools/scale_run.py): the corpus byte for byte
from the same seed, and the whole run on the CPU (device="cpu": KC, S1, K1
and K2 through their plain versions) giving the JAX tool's -W list and PAF
on the same work directory; the origin check on both strands; a mapping
call recorded and held to the plain versions (extend/check.hold_call).

The run's main corpus here is 3 Mbp with two reads of about 3 kb, each
mapped uniquely: at 2 Mbp from seed 11 two of the first four reads lie
wholly inside a 20 kb tandem-repeat array (eight of them make 8% of such a
genome), so each maps equally at six places and costs six reads' DP
through the plain K1.  A read of 500 bases inside an array is the repeat
case of its own, held to the JAX tool's PAF with its secondaries.  A
corpus is reused only for the request it was made for.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
JAX_TOOL = REPO / "tests" / "tools" / "scale_run.py"


def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_scale_run", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_tool_run(wd: Path) -> int:
    """The JAX tool's steps on the corpus in `wd`, in process and without
    its summary's timings: the -W list when it is absent (memory-bounded
    counting, the 0.9998 distinct threshold), the index, and the mapping
    written to scale_ours.paf through its PAF writer.  Returns the index's
    minimizer count."""
    from winnowmap_tpu.index.build import build_index, load_weight_set
    from winnowmap_tpu.io.fastx import read_all
    from winnowmap_tpu.kcount import count_kmers
    from winnowmap_tpu.map.batch import map_batch
    from winnowmap_tpu.map.pipeline import _write_read
    from winnowmap_tpu.options import (IndexOptions, MapOptions, MM_F_CIGAR,
                                       MM_F_OUT_CG, update_mid_occ)

    ref, reads, rep = (wd / "scale_ref.fa", wd / "scale_reads.fa",
                       wd / "scale_rep.txt")
    if not rep.exists():
        kc = count_kmers(read_all(str(ref)), 15,
                         max_memory_bytes=int(24.0 * 1e9))
        thr = kc.threshold_distinct(0.9998)
        with open(rep, "w") as f:
            for line in kc.greater_than(thr).print_lines():
                f.write(line + "\n")
    io_, mo = IndexOptions(), MapOptions()
    mo.flag |= MM_F_CIGAR | MM_F_OUT_CG
    mi = build_index(read_all(str(ref)), io_.w, io_.k, io_.flag,
                     load_weight_set(str(rep), io_.k))
    update_mid_occ(mo, mi)
    rd = read_all(str(reads))
    results = map_batch(mi, mo, [r.seq for r in rd], [r.name for r in rd])
    with open(wd / "scale_ours.paf", "w") as f:
        for rec, res in zip(rd, results):
            _write_read(mi, mo, rec, res, f)
    return int(mi.pos.shape[0])


@pytest.mark.parametrize("gbp", [0.001, 0.0010001],
                         ids=["whole-lines", "partial-last-line"])
def test_make_corpus_matches_jax_tool(tmp_path, gbp):
    """One chromosome of 1 Mbp with its eight arrays and 20 reads of 15 +-
    5 kb: both files byte-equal to the JAX tool's (at 1,000,100 bases the
    last FASTA line is partial)."""
    from winnowmap_tpu_torch.tools.scale_run import make_corpus

    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    want = jax_tool().make_corpus(a, gbp, 20, 15000, 11)
    got = make_corpus(b, gbp, 20, 15000, 11)
    for w, g in zip(want, got):
        assert w.name == g.name
        assert w.read_bytes() == g.read_bytes(), w.name


def test_scale_run_matches_jax_tool(tmp_path, capsys):
    """The port's run on the CPU, then the JAX tool's steps (host counter,
    host kernels) in process on the same work directory: the same -W list,
    minimizer count and PAF, every check of the run passed, and its
    SCALE-SUMMARY line last."""
    from winnowmap_tpu_torch.tools.scale_run import main

    args = ["--workdir", str(tmp_path), "--gbp", "0.003", "--n-reads", "2",
            "--read-len", "3000"]
    assert main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    summary = dict(kv.split("=", 1) for kv in out[-1].split()[1:])
    assert out[-1].startswith("SCALE-SUMMARY ")
    assert summary["eng_host_dp_calls"] == "0"
    assert summary["origin_share"] == "1.0"
    assert summary["device"] == '"cpu"'
    rep = (tmp_path / "scale_rep.txt").read_bytes()
    paf = (tmp_path / "scale_ours.paf").read_bytes()
    assert rep and paf.count(b"\n") >= 2
    (tmp_path / "scale_rep.txt").unlink()
    assert str(jax_tool_run(tmp_path)) == summary["n_minimizers"]
    assert (tmp_path / "scale_rep.txt").read_bytes() == rep
    assert (tmp_path / "scale_ours.paf").read_bytes() == paf


def test_scale_run_repeat_read_matches_jax_tool(tmp_path, capsys):
    """A read of 500 bases from the reverse strand wholly inside one of
    the 2 Mbp genome's 20 kb tandem-repeat arrays (seed 11's first read):
    it maps equally at many copies of the array's unit, so the run writes
    a primary and five secondaries, all of one score and MAPQ 0, and its
    origin check fails, naming the read, since the primary is a copy off
    the sampled interval.  The -W list and the PAF, multi-mapping lines
    included, are byte-equal to the JAX tool's on the same work
    directory."""
    from winnowmap_tpu_torch.tools.scale_run import ScaleCheckFailed, run

    with pytest.raises(ScaleCheckFailed, match="0.00% of the reads"):
        run(tmp_path, gbp=0.002, n_reads=1, read_len=500, device="cpu")
    assert "read off its origin: read0_chr1_1430514_-" in \
        capsys.readouterr().out
    rep = (tmp_path / "scale_rep.txt").read_bytes()
    paf = (tmp_path / "scale_ours.paf").read_bytes()
    lines = [ln.split("\t") for ln in paf.decode().splitlines()]
    assert [f[0] for f in lines] == ["read0_chr1_1430514_-"] * 6
    assert [t for f in lines for t in f if t.startswith("tp:A:")] == \
        ["tp:A:P"] + ["tp:A:S"] * 5
    assert {f[14] for f in lines} == {"AS:i:766"} and lines[0][11] == "0"
    (tmp_path / "scale_rep.txt").unlink()
    jax_tool_run(tmp_path)
    assert (tmp_path / "scale_rep.txt").read_bytes() == rep
    assert (tmp_path / "scale_ours.paf").read_bytes() == paf


BASE = dict(gbp=0.001, n_reads=2, read_len=3000, seed=11)


@pytest.mark.parametrize("change", [
    {}, {"gbp": 0.0010001}, {"n_reads": 3}, {"read_len": 2000},
    {"seed": 12}], ids=["same", "gbp", "n_reads", "read_len", "seed"])
def test_make_corpus_reused_only_for_its_request(tmp_path, capsys, change):
    """A corpus left in the work directory is reused for the same request
    (its files untouched) and made anew for any other genome size, read
    count, read length or seed: the files are then those of a fresh
    directory."""
    from winnowmap_tpu_torch.tools.scale_run import make_corpus

    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    first = make_corpus(a, **BASE)
    before = [p.read_bytes() for p in first]
    stamps = [p.stat().st_mtime_ns for p in first]
    capsys.readouterr()
    got = make_corpus(a, **dict(BASE, **change))
    out = capsys.readouterr().out
    if not change:
        assert "corpus present, reusing" in out
        assert [p.stat().st_mtime_ns for p in got] == stamps
        assert [p.read_bytes() for p in got] == before
        return
    assert "making it anew" in out
    want = make_corpus(b, **dict(BASE, **change))
    assert [p.read_bytes() for p in got] == [p.read_bytes() for p in want]
    assert [p.read_bytes() for p in got] != before


def test_make_corpus_without_stamp_made_anew(tmp_path, capsys):
    """Files the JAX tool left (it writes no stamp) are not taken on
    trust: the corpus is made again and stamped."""
    from winnowmap_tpu_torch.tools.scale_run import CORPUS_STAMP, make_corpus

    jax_tool().make_corpus(tmp_path, **BASE)
    capsys.readouterr()
    make_corpus(tmp_path, **BASE)
    assert "reusing" not in capsys.readouterr().out
    assert (tmp_path / CORPUS_STAMP).exists()
    make_corpus(tmp_path, **BASE)
    assert "corpus present, reusing" in capsys.readouterr().out


@pytest.mark.parametrize("tamper", ["short-genome", "missing-read"])
def test_run_refuses_a_corpus_of_another_size(tmp_path, tamper):
    """A stamped corpus whose files do not hold the genome size or the
    read count asked for fails the run's first check, before any count."""
    from winnowmap_tpu_torch.tools.scale_run import (ScaleCheckFailed,
                                                     make_corpus, run)

    ref, reads = make_corpus(tmp_path, **BASE)
    if tamper == "short-genome":
        ref.write_bytes(ref.read_bytes()[:-81])
    else:
        reads.write_bytes(b"".join(reads.read_bytes().splitlines(True)[:2]))
    with pytest.raises(ScaleCheckFailed, match="the corpus is the one "):
        run(tmp_path, **BASE, device="cpu")
    assert not (tmp_path / "scale_rep.txt").exists()


def paf_line(name, qlen, strand, chrom, ts, te, tp="P"):
    f = [name, str(qlen), "0", str(qlen), strand, chrom, "1000000", str(ts),
         str(te), "900", str(qlen), "60", "NM:i:5"]
    if tp:
        f.append(f"tp:A:{tp}")
    return "\t".join(f)


def test_read_origin():
    from winnowmap_tpu_torch.tools.scale_run import read_origin

    assert read_origin("read12_chr3_4567_-") == ("chr3", 4567, "-")
    assert read_origin("read0_chr1_0_+") == ("chr1", 0, "+")
    with pytest.raises(ValueError):
        read_origin("read0_chr1_0_x")


def test_origin_misses_both_strands():
    """A primary hit on the read's chromosome and strand that overlaps
    [pos, pos + qlen) is on its origin, on either strand; the first
    tp:A:P line counts (a secondary line before it does not), and a line
    without a tp tag is taken as primary."""
    from winnowmap_tpu_torch.tools.scale_run import origin_misses

    lines = [
        # on origin: forward, reverse, touching either end of the interval
        paf_line("read0_chr1_1000_+", 500, "+", "chr1", 1000, 1500),
        paf_line("read1_chr2_2000_-", 500, "-", "chr2", 2010, 2490),
        paf_line("read2_chr1_3000_+", 500, "+", "chr1", 3499, 4000),
        paf_line("read3_chr1_3000_-", 500, "-", "chr1", 2600, 3001),
        # a secondary elsewhere, then the primary on origin
        paf_line("read4_chr1_5000_-", 500, "-", "chr3", 9000, 9500, "S"),
        paf_line("read4_chr1_5000_-", 500, "-", "chr1", 5000, 5500),
        # no tp tag: the first line
        paf_line("read5_chr2_100_+", 500, "+", "chr2", 100, 600, None),
        # misses: the other strand, the other chromosome, just past either
        # end, a primary elsewhere after a secondary on origin
        paf_line("read6_chr1_1000_+", 500, "-", "chr1", 1000, 1500),
        paf_line("read7_chr1_1000_-", 500, "-", "chr2", 1000, 1500),
        paf_line("read8_chr1_1000_+", 500, "+", "chr1", 1500, 2000),
        paf_line("read9_chr1_1000_-", 500, "-", "chr1", 500, 1000),
        paf_line("read10_chr1_1000_+", 500, "+", "chr1", 1000, 1500, "S"),
        paf_line("read10_chr1_1000_+", 500, "+", "chr1", 8000, 8500),
    ]
    names = [f"read{i}_{c}" for i, c in enumerate(
        ["chr1_1000_+", "chr2_2000_-", "chr1_3000_+", "chr1_3000_-",
         "chr1_5000_-", "chr2_100_+", "chr1_1000_+", "chr1_1000_-",
         "chr1_1000_+", "chr1_1000_-", "chr1_1000_+", "chr4_7_+"])]
    # read11 has no line at all
    assert origin_misses("\n".join(lines) + "\n", names) == [
        "read6_chr1_1000_+", "read7_chr1_1000_-", "read8_chr1_1000_+",
        "read9_chr1_1000_-", "read10_chr1_1000_+", "read11_chr4_7_+"]


def test_scale_run_needs_a_card_unless_told():
    """device=None means the card: without one the run raises before it
    writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from winnowmap_tpu_torch.tools.scale_run import run

    with pytest.raises(RuntimeError, match="CUDA"):
        run("/nonexistent/scale", gbp=0.001, n_reads=1)


def test_recorded_call_held_to_plain(monkeypatch):
    """A DevCallPooled call recorded by check.CallRecorder and held by
    check.hold_call: equal to the plain versions, and unequal once the
    wrapper's results are disturbed, as a faulty kernel's would be (the
    check is not vacuous)."""
    from winnowmap_tpu_torch.extend import check as XC
    from winnowmap_tpu_torch.extend import kernels as K
    from winnowmap_tpu_torch.index.build import MinimizerIndex
    from winnowmap_tpu_torch.map.align import gen_simple_mat

    rng = np.random.default_rng(16)
    qpool, tpool, jobs, _, _ = XC.random_jobs(rng, [90, 150, 60], 40, 100)
    mi = MinimizerIndex(w=10, k=15, codes=tpool)
    pools = K.PoolContext(qpool, mi, torch.device("cpu"))
    with XC.CallRecorder("extd") as rec:
        K.DevCallPooled(pools, jobs, gen_simple_mat(2, 4, 1), 4, 2, 24, 1,
                        0, 0x0).collect_blob()
    assert K.extd_dp is rec.dp
    picks = rec.picks()
    assert len(rec.calls) == 1 and len(picks) == 1
    path, rows, c = picks[0]
    assert rows == int((jobs[:, 1] + jobs[:, 4] - 1).max())
    assert XC.hold_call(c, "extd", rows)
    wrapper = K.extd_dp

    def disturbed(**kw):
        res, dirs = wrapper(**kw)
        res[0, 0] += 1  # the first job's score
        return res, dirs

    monkeypatch.setattr(K, "extd_dp", disturbed)
    assert not XC.hold_call(c, "extd", rows)


def test_oracle_differential(tmp_path):
    """The differential against a reference binary's PAF (here a script
    that prints one): sorted lines compared whole, then without the chain
    statistics and rl; the binary runs once, its PAF kept."""
    from winnowmap_tpu_torch.tools.scale_run import oracle_differential

    a = paf_line("read0_chr1_1000_+", 500, "+", "chr1", 1000, 1500)
    b = paf_line("read1_chr1_2000_-", 500, "-", "chr1", 2000, 2500)
    c = paf_line("read2_chr1_3000_+", 500, "+", "chr1", 3000, 3500)
    ours = tmp_path / "ours.paf"
    ours.write_text("\n".join([c + "\tcm:i:9\ts1:i:80", a, b]) + "\n")
    theirs = tmp_path / "theirs.paf"
    theirs.write_text("\n".join([
        a, b.replace("\t2500\t", "\t2501\t"),
        c + "\tcm:i:7\ts1:i:81"]) + "\n")
    fake = tmp_path / "winnowmap"
    fake.write_text(f"#!/bin/sh\ncat {theirs}\n")
    fake.chmod(0o755)
    ref_out = tmp_path / "ref.paf"
    summary = {}
    oracle_differential(str(fake), tmp_path / "rep.txt", tmp_path / "r.fa",
                        tmp_path / "q.fa", ours, ref_out, summary)
    assert ref_out.read_text() == theirs.read_text()
    assert "oracle_s" in summary
    assert (summary["paf_lines_ours"], summary["paf_lines_ref"],
            summary["paf_lines_equal"], summary["paf_alnfields_equal"]) \
        == (3, 3, 1, 2)
    summary = {}
    fake.unlink()
    oracle_differential(str(fake), tmp_path / "rep.txt", tmp_path / "r.fa",
                        tmp_path / "q.fa", ours, ref_out, summary)
    assert "oracle_s" not in summary and summary["paf_lines_equal"] == 1
