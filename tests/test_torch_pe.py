"""Paired-end and fragment mapping in the port (map/pe.py, frag.map_frag_gen,
batch.map_batch_frags, pipeline.map_file_frag, the CLI's several query
files, --frag and -F) against the JAX package: select_sub_multi, pair,
set_pe_thru and seg_gen equal winnowmap_tpu's on seeded inputs;
golden_pe.sam (the patched reference oracle's paired SAM) through the
port's CLI on the CPU apart from @PG; --frag yes on the two files
interleaved gives the two files' body; the CLI's output equals the JAX
CLI's on its host kernels (WM_NO_TPU=1).  All comparisons are exact."""
import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLD = REPO / "tests" / "data" / "golden"
SEED = 20261018


def _out(fn, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(list(argv), **kw)
    assert rc == 0
    return buf.getvalue()


def _body(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@")]


def _no_pg(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@PG")]


@pytest.fixture(scope="module")
def pe_corpus(tmp_path_factory):
    """30 pairs of 2 x 150 bp from fragments of 400 bp (6 substitutions
    each) on a 60 kb genome, numpy seed SEED (the JAX test_pe corpus's
    layout); the two files and their interleaving."""
    d = tmp_path_factory.mktemp("pe")
    rng = np.random.default_rng(SEED)
    acgt = b"ACGT"
    genome = bytes(acgt[c] for c in rng.integers(0, 4, 60000))
    reads = ([], [])
    for i in range(30):
        s = int(rng.integers(0, len(genome) - 500))
        frag = bytearray(genome[s:s + 400])
        for _ in range(6):
            frag[int(rng.integers(0, 400))] = acgt[int(rng.integers(0, 4))]
        reads[0].append((f"pair{i}/1", bytes(frag[:150])))
        reads[1].append((f"pair{i}/2", bytes(frag[250:])))
    (d / "ref.fa").write_text(">chr1\n" + genome.decode() + "\n")
    (d / "rep.txt").write_text("ACGTACGTACGTACG\t100\n")

    def fq(recs):
        return "".join(f"@{n}\n{s.decode()}\n+\n{'I' * len(s)}\n"
                       for n, s in recs)

    (d / "r1.fq").write_text(fq(reads[0]))
    (d / "r2.fq").write_text(fq(reads[1]))
    (d / "inter.fq").write_text(fq([r for pr in zip(*reads) for r in pr]))
    return d


def _regs(mod, rng, n, rid_hi=2):
    regs = []
    for i in range(n):
        r = mod.Reg(id=i, parent=i, rid=int(rng.integers(0, rid_hi)),
                    score=int(rng.integers(30, 300)),
                    rev=bool(rng.integers(0, 2)),
                    hash=int(rng.integers(0, 1 << 32)),
                    qs=int(rng.integers(0, 300)),
                    rs=int(rng.integers(0, 3000)), sam_pri=True,
                    mapq=int(rng.integers(0, 61)))
        r.qe = r.qs + int(rng.integers(20, 150))
        r.re = r.rs + int(rng.integers(20, 150))
        r.score0 = r.score
        r.p = mod.Extra(dp_max=int(rng.integers(20, 300)))
        regs.append(r)
    return regs


def _fields(regs):
    return [(r.id, r.parent, r.rid, r.score, r.qs, r.qe, r.rs, r.re, r.rev,
             r.mapq, r.sam_pri, r.proper_frag, r.pe_thru, r.subsc, r.n_sub,
             r.seg_id, r.seg_split, r.n_segs, r.hash, r.cnt, r.as_)
            for r in regs]


@pytest.mark.parametrize("seed", range(4))
def test_select_sub_multi_matches_jax(seed):
    """Secondary selection over two segments (mm_select_sub_multi) after
    the same set_parent, on seeded regions close and far on the
    reference."""
    from winnowmap_tpu.map import hit as jhit
    from winnowmap_tpu.map.pe import select_sub_multi as jax_ssm
    from winnowmap_tpu_torch.map import hit as phit
    from winnowmap_tpu_torch.map.pe import select_sub_multi

    out = []
    for mod, fn in ((jhit, jax_ssm), (phit, select_sub_multi)):
        regs = _regs(mod, np.random.default_rng(SEED + seed), 12)
        mod.set_parent(0.5, 0, regs, 8, 0, 0.15)
        out.append(_fields(fn(0.8, 0.2, 0.7, 800, 30, 3, 2, [150, 150],
                              regs)))
    assert out[1] == out[0]


@pytest.mark.parametrize("seed", range(4))
def test_pair_and_set_pe_thru_match_jax(seed):
    """mm_pair (best pair, proper_frag, parent lifts, sam_pri sync, the
    MAPQ blend) and mm_set_pe_thru on two segments' seeded regions."""
    from winnowmap_tpu.map import hit as jhit
    from winnowmap_tpu.map.pe import pair as jax_pair
    from winnowmap_tpu.map.pe import set_pe_thru as jax_thru
    from winnowmap_tpu_torch.map import hit as phit
    from winnowmap_tpu_torch.map.pe import pair, set_pe_thru

    out = []
    for mod, fn, thru in ((jhit, jax_pair, jax_thru),
                          (phit, pair, set_pe_thru)):
        rng = np.random.default_rng(SEED + 100 + seed)
        segs = [_regs(mod, rng, int(rng.integers(1, 6)), 1)
                for _ in range(2)]
        for regs in segs:
            mod.set_parent(0.5, 0, regs, 8, 0, 0.15)
        fn(1000, 33, 8, 2, [150, 150], segs)
        # a read-through pair: one primary each at the same locus
        a, b = _regs(mod, rng, 1), _regs(mod, rng, 1)
        b[0].rid, b[0].rev = a[0].rid, a[0].rev
        b[0].rs, b[0].re = a[0].rs + 1, a[0].re - 1
        a[0].qs, b[0].qe = 0, 150
        thru([a[0].qe, 150], [a, b])
        out.append([_fields(s) for s in segs] + [_fields(a + b)])
    assert out[1] == out[0]
    assert out[0][2][0][12]  # pe_thru set


@pytest.mark.parametrize("seed", range(3))
def test_seg_gen_matches_jax(seed):
    """mm_seg_gen on seeded chains over two and three segments, both
    strands: each segment's regions, rebased anchors and their order."""
    from winnowmap_tpu.map import hit as jhit
    from winnowmap_tpu_torch.map import hit as phit
    from winnowmap_tpu_torch.options import MM_SEED_SEG_SHIFT

    rng = np.random.default_rng(SEED + 200 + seed)
    qlens = [int(v) for v in rng.integers(100, 300, 2 + seed % 2)]
    acc = np.concatenate([[0], np.cumsum(qlens)[:-1]])
    tot = sum(qlens)
    ax, ay, u = [], [], []
    for _ in range(int(rng.integers(2, 7))):
        rev = int(rng.integers(0, 2))
        cnt = int(rng.integers(1, 9))
        rid = int(rng.integers(0, 3))
        for j in range(cnt):
            s = int(rng.integers(0, len(qlens)))
            p = int(rng.integers(0, qlens[s]))
            q = (tot - acc[s] - qlens[s] + p) if rev else acc[s] + p
            ax.append((rev << 63) | (rid << 32) | int(rng.integers(0, 1e6)))
            ay.append((s << MM_SEED_SEG_SHIFT) | (15 << 32) | int(q))
        u.append((int(rng.integers(20, 500)) << 32) | cnt)
    ax = np.array(ax, np.uint64)
    ay = np.array(ay, np.uint64)
    u = np.array(u, np.uint64)
    got, want = [], []
    for mod, dst in ((phit, got), (jhit, want)):
        regs0 = mod.gen_regs(77, tot, u, ax, ay)
        for regs, sx, sy in mod.seg_gen(77, qlens, regs0, ax, ay):
            dst.append((_fields(regs), sx.tolist(), sy.tolist()))
    assert got == want


def test_pe_golden_through_port_cli():
    """golden_pe.sam (`-a -W pe_rep.txt pe_ref.fa pe_1.fq pe_2.fq`, the
    patched reference oracle): the port's CLI on the CPU equals it apart
    from @PG."""
    from winnowmap_tpu_torch.cli import main as port_main

    got = _out(port_main, ["-a", "-W", str(GOLD / "pe_rep.txt"),
                           str(GOLD / "pe_ref.fa"), str(GOLD / "pe_1.fq"),
                           str(GOLD / "pe_2.fq")], device="cpu")
    assert _no_pg(got) == _no_pg((GOLD / "golden_pe.sam").read_text())


@pytest.mark.parametrize("extra", [["-a"], ["-c", "-F", "600"]],
                         ids=["frag", "F"])
def test_cli_frag_matches_jax_cli(extra, pe_corpus, monkeypatch):
    """--frag yes on one interleaved file: the same records as the two
    files (SAM body), and each run byte-equal to the JAX CLI's; -F (the
    fragment length that widens the reference gap, max_frag_len) with -c
    likewise."""
    from winnowmap_tpu.cli import main as jax_main
    from winnowmap_tpu_torch.cli import main as port_main

    monkeypatch.setenv("WM_NO_TPU", "1")
    d = pe_corpus
    base = extra + ["-W", str(d / "rep.txt"), str(d / "ref.fa")]
    two = base + [str(d / "r1.fq"), str(d / "r2.fq")]
    inter = base[:-1] + ["--frag", "yes", str(d / "ref.fa"),
                         str(d / "inter.fq")]
    got_two = _out(port_main, two, device="cpu")
    got_inter = _out(port_main, inter, device="cpu")
    assert _body(got_inter) == _body(got_two)
    assert got_two == _out(jax_main, two)
    assert got_inter == _out(jax_main, inter)
    lines = _body(got_two)
    assert len(lines) >= 55
    if extra[0] == "-a":  # at least 90% of the pairs properly paired
        flags = [int(ln.split("\t")[1]) for ln in lines]
        proper = sum(1 for f in flags
                     if f & 0x40 and f & 0x2 and not f & 0x904)
        assert proper >= 27


def _rc_fq(src, dst):
    """`src` with every record reverse-complemented (quality reversed)."""
    lines = src.read_text().splitlines()
    comp = bytes.maketrans(b"ACGTN", b"TGCAN")
    for i in range(1, len(lines), 4):
        lines[i] = lines[i].encode().translate(comp)[::-1].decode()
        lines[i + 2] = lines[i + 2][::-1]
    dst.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("pe_ori,extra", [(1, "-a"), (1, "-c"), (2, "-a")],
                         ids=["FR-sam", "FR-paf", "RF-sam"])
def test_pe_ori_flip_matches_jax(pe_ori, extra, pe_corpus, tmp_path,
                                 monkeypatch):
    """map_file_frag with pe_ori set (no preset of either CLI sets it, so
    both packages get it patched in): the mate that pe_ori names is given
    reverse-complemented, is flipped to the forward strand for mapping and
    its regions flipped back (qs/qe and the strand).  The port's output is
    byte-equal to the JAX package's, and pe_ori's mates map where the
    forward mates of the two files do."""
    import winnowmap_tpu.map.pipeline as jax_pipeline
    import winnowmap_tpu_torch.cli as port_cli
    from winnowmap_tpu.cli import main as jax_main

    def with_pe_ori(fn):
        def run(mi, opt, *a, **kw):
            opt.pe_ori = pe_ori
            return fn(mi, opt, *a, **kw)
        return run

    monkeypatch.setenv("WM_NO_TPU", "1")
    d = pe_corpus
    mates = [d / "r1.fq", d / "r2.fq"]
    j = 1 if pe_ori & 1 else 0
    mates[j] = tmp_path / f"r{j + 1}_rc.fq"
    _rc_fq(d / f"r{j + 1}.fq", mates[j])
    argv = [extra, "-W", str(d / "rep.txt"), str(d / "ref.fa"),
            *map(str, mates)]
    fwd = _out(port_cli.main, argv[:-2] + [str(d / "r1.fq"),
                                             str(d / "r2.fq")],
               device="cpu")
    monkeypatch.setattr(port_cli, "map_file_frag",
                        with_pe_ori(port_cli.map_file_frag))
    monkeypatch.setattr(jax_pipeline, "map_file_frag",
                        with_pe_ori(jax_pipeline.map_file_frag))
    got = _out(port_cli.main, argv, device="cpu")
    assert got == _out(jax_main, argv)

    def where(text):
        return [(ln.split("\t")[0], ln.split("\t")[2:4] if extra == "-a"
                 else ln.split("\t")[5:9]) for ln in _body(text)]

    assert len(_body(got)) >= 55
    assert where(got) == where(fwd)


def test_cli_frag_refuses_splice(pe_corpus):
    """--frag with a spliced preset exits as the JAX CLI does."""
    from winnowmap_tpu_torch.cli import main as port_main

    d = pe_corpus
    with pytest.raises(SystemExit, match="--splice and --frag"):
        port_main(["-x", "splice", "--frag", "yes", str(d / "ref.fa"),
                   str(d / "inter.fq")], device="cpu")
