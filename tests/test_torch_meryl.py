"""The port's meryl tools (winnowmap_tpu_torch/meryl_cli.py,
meryl_simple_cli.py) with `--device cpu` (KC's plain version): the golden
outputs of the reference meryl (tests/data/golden: print md5, histogram,
distinct=0.9998, greater-than 4), and every operation of
tests/test_kcount.py and tests/test_meryl_ops.py against the JAX package's
meryl_cli on the same databases (the JAX package counting on the host):
the n-ary, math, compare, ploidy, statistics, filter, count-direction and
nested-tree outputs byte-equal; the database written by either package
read by the other, and both packages' databases byte-equal.
"""
import hashlib
import os

import numpy as np
import pytest
import torch

from winnowmap_tpu_torch import kcount as PK
from winnowmap_tpu_torch.io.fastx import read_all

torch.set_num_threads(1)


def _ours(args, capsys):
    from winnowmap_tpu_torch.meryl_cli import main

    capsys.readouterr()
    assert main(args + ["--device", "cpu"]) == 0
    return capsys.readouterr().out


def _jax(args, capsys):
    from winnowmap_tpu.meryl_cli import main

    capsys.readouterr()
    assert main(args) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def dbs(tmp_path_factory, golden_dir):
    """The port's databases of t_ref.fa and t_reads.fa (k = 15), counted
    on the CPU through the port's CLI."""
    from winnowmap_tpu_torch.meryl_cli import main

    tmp = tmp_path_factory.mktemp("torch_meryl")
    out = []
    for name in ("t_ref.fa", "t_reads.fa"):
        db = str(tmp / name.replace(".fa", ""))
        assert main(["count", "k=15", "output", db, str(golden_dir / name),
                     "--device", "cpu"]) == 0
        out.append(db)
    return out


GOLDEN = {"print": (["print"], "golden_meryl_print.md5"),
          "histogram": (["histogram"], "golden_meryl_histogram.txt"),
          "distinct": (["print", "greater-than", "distinct=0.9998"],
                       "golden_meryl_rep_distinct9998.txt"),
          "gt4": (["print", "greater-than", "4"], "golden_meryl_gt4.txt")}


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden(case, dbs, golden_dir, capsys):
    """The reference meryl's outputs on t_ref.fa, byte for byte (print as
    the golden md5)."""
    args, gold = GOLDEN[case]
    got = _ours(args + [dbs[0]], capsys)
    want = (golden_dir / gold).read_text()
    if gold.endswith(".md5"):
        assert hashlib.md5(got.encode()).hexdigest() == want.strip()
    elif case == "histogram":
        assert [tuple(map(int, ln.split())) for ln in got.splitlines()] == \
            [tuple(map(int, ln.split())) for ln in want.splitlines()]
    else:
        assert got.splitlines() == want.splitlines()


NARY = ["union", "union-min", "union-max", "union-sum",
        "intersect", "intersect-min", "intersect-max", "intersect-sum",
        "subtract", "difference", "symmetric-difference"]
REVERSED = ["union", "union-sum", "intersect", "intersect-sum", "subtract",
            "symmetric-difference"]
MATH = [("increase", "3"), ("decrease", "2"), ("multiply", "5"),
        ("divide", "2"), ("divide-round", "2"), ("modulo", "3")]
CASES = ([(f"nary-{op}", ["print", op, 0, 1]) for op in NARY]
         + [(f"nary-reversed-{op}", ["print", op, 1, 0]) for op in REVERSED]
         + [(f"math-{op}", ["print", op, c, 0]) for op, c in MATH]
         + [("compare", ["compare", 0, 1]), ("ploidy", ["ploidy", 0]),
            ("statistics", ["statistics", 1]), ("histogram", ["histogram", 1])]
         + [(f"filter-{f}", ["print", f, a, 1]) for f, a in (
             ("less-than", "2"), ("at-least", "3"), ("at-most", "1"),
             ("equal-to", "2"), ("not-equal-to", "1"),
             ("greater-than", "word-frequency=0.00001"),
             ("at-least", "distinct=0.9"))])


@pytest.mark.parametrize("name,args", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(name, args, dbs, capsys):
    """Every op of the flat command line over the port's two databases:
    the port's stdout equals the JAX package's."""
    args = [dbs[a] if isinstance(a, int) else a for a in args]
    assert _ours(args, capsys) == _jax(args, capsys)


@pytest.mark.parametrize("direction", ["count", "count-forward",
                                       "count-reverse"])
def test_count_direction_matches_jax(direction, golden_dir, tmp_path,
                                     capsys):
    """`print [ count-forward k=15 t_ref.fa ]` (and reverse, canonical):
    the port's tree equals the JAX package's, and equals the flat count
    written to a database and printed."""
    fa = str(golden_dir / "t_ref.fa")
    tree = ["print", "[", direction, "k=15", fa, "]"]
    got = _ours(tree, capsys)
    assert got == _jax(tree, capsys)
    db = str(tmp_path / "db")
    _ours([direction, "k=15", "output", db, fa], capsys)
    assert _ours(["print", db], capsys) == got


def test_nested_op_tree(golden_dir, dbs, capsys):
    """A union-sum of two count subtrees equals the flat union-sum of the
    two databases (tests/test_kcount.py::test_meryl_nested_op_tree)."""
    flat = _ours(["print", "union-sum", dbs[0], dbs[1]], capsys)
    tree = _ours(["print", "union-sum",
                  "[", "count", "k=15", str(golden_dir / "t_ref.fa"), "]",
                  "[", "count", "k=15", str(golden_dir / "t_reads.fa"),
                  "]"], capsys)
    assert tree == flat


def test_nested_math_in_tree(dbs, tmp_path, capsys):
    """Math inside a tree equals the flat ops piped through import
    (tests/test_meryl_ops.py::test_nested_math_in_tree), and the JAX
    package's tree."""
    doubled = _ours(["print", "multiply", "2", dbs[0]], capsys)
    dump = tmp_path / "x2.txt"
    dump.write_text(doubled)
    imp = str(tmp_path / "x2db")
    _ours(["import", "-k", "15", "-kmers", str(dump), "-output", imp],
          capsys)
    flat = _ours(["print", "union-sum", imp, dbs[1]], capsys)
    tree = ["print", "union-sum", "[", "multiply", "2", dbs[0], "]",
            "[", dbs[1], "]"]
    got = _ours(tree, capsys)
    assert got == flat
    assert got == _jax(tree, capsys)


def test_import_roundtrip(dbs, tmp_path, capsys):
    """'KMER count' text -> database -> print round-trips."""
    text = _ours(["print", dbs[0]], capsys)
    dump = tmp_path / "dump.txt"
    dump.write_text(text)
    imp = str(tmp_path / "imp")
    _ours(["import", "-k", "15", "-kmers", str(dump), "-output", imp],
          capsys)
    assert _ours(["print", imp], capsys) == text


def test_db_roundtrip(dbs, golden_dir, tmp_path):
    kc = PK.count_kmers(read_all(str(golden_dir / "t_ref.fa")), 15,
                        device="cpu")
    kc.save(str(tmp_path / "db"))
    back = PK.KmerCounts.load(str(tmp_path / "db"))
    assert back.k == kc.k
    assert np.array_equal(back.kmers, kc.kmers)
    assert np.array_equal(back.counts, kc.counts)


def _tree(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_db_interop(writer, dbs, golden_dir, tmp_path):
    """A database the port writes, the JAX package reads, and the other
    way: the same k-mers and counts; both packages' databases of t_ref.fa
    are the same 129 files, byte for byte."""
    from winnowmap_tpu.kcount import KmerCounts as JK
    from winnowmap_tpu.kcount import count_kmers as jcount

    jdb = str(tmp_path / "jdb")
    jkc = jcount(read_all(str(golden_dir / "t_ref.fa")), 15,
                 use_device=False)
    jkc.save(jdb)
    if writer == "port":
        src, back = dbs[0], JK.load(dbs[0])
        want = jkc
    else:
        src, back = jdb, PK.KmerCounts.load(jdb)
        want = PK.KmerCounts.load(dbs[0])
    assert back.k == want.k == 15
    assert np.array_equal(back.kmers, want.kmers)
    assert np.array_equal(back.counts, want.counts)
    assert len(_tree(src)) == 129
    assert _tree(dbs[0]) == _tree(jdb)


def test_set_algebra_and_lookup(golden_dir):
    """tests/test_kcount.py's set algebra and lookup on the port's counts:
    a union of two records' counts equals counting both."""
    recs = read_all(str(golden_dir / "t_ref.fa"))
    a = PK.count_kmers(recs[:1], 11, device="cpu")
    b = PK.count_kmers(recs[1:], 11, device="cpu")
    both = PK.count_kmers(recs, 11, device="cpu")
    u = a.union_sum(b)
    assert np.array_equal(u.kmers, both.kmers)
    assert np.array_equal(u.counts, both.counts)
    i = a.intersect_min(b)
    assert np.isin(i.kmers, a.kmers).all() and np.isin(i.kmers, b.kmers).all()
    assert not np.isin(a.difference(b).kmers, b.kmers).any()
    s = both.subtract(a)
    assert np.array_equal(s.kmers, b.kmers)
    assert np.array_equal(s.counts, b.counts)
    c15 = PK.count_kmers(recs, 15, device="cpu")
    res = PK.lookup(c15, recs[0].seq[:1000])
    assert len(res) == 1000 - 14 and (res >= 1).all()


def test_meryl_simple_matches_jax(golden_dir, tmp_path):
    """meryl-simple's dump, histogram and database equal the JAX
    package's."""
    from winnowmap_tpu.meryl_simple_cli import main as jmain

    from winnowmap_tpu_torch.meryl_simple_cli import main

    fa = str(golden_dir / "t_ref.fa")
    for who, fn, extra in (("u", main, ["--device", "cpu"]),
                           ("j", jmain, [])):
        assert fn(["-k", "15", "-S", fa, "-D", str(tmp_path / f"{who}.dump"),
                   "-H", str(tmp_path / f"{who}.hist"),
                   "-M", str(tmp_path / f"{who}.db")] + extra) == 0
    for ext in ("dump", "hist"):
        assert (tmp_path / f"u.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    assert _tree(tmp_path / "u.db") == _tree(tmp_path / "j.db")


def test_meryl_count_needs_a_card(golden_dir, tmp_path, monkeypatch):
    """Without --device cpu a count runs on the card, and without one it
    raises rather than counting on the CPU."""
    from winnowmap_tpu_torch.meryl_cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["count", "k=15", "output", str(tmp_path / "db"),
              str(golden_dir / "t_ref.fa")])
