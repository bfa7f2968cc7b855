"""The genome, the reads and the genes: deterministic from their seeds and
shaped as the configurations and mixes say (CPU, small sizes)."""
import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest

from wmbench import genome as G
from wmbench import reads as R

HERE = Path(__file__).resolve().parent.parent


def _cfg(name, chrom_bp=2_000_000, n=2):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg["chromosomes"], cfg["chrom_bp"] = n, chrom_bp
    cfg["genome"]["satellite"]["array_bp"] = 120_000
    if cfg["genome"].get("genes"):
        cfg["genome"]["genes"]["intron"]["max_bp"] = 30_000
    return cfg


def _mix(name, **kw):
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    mix.update(kw)
    return mix


@pytest.fixture(scope="module")
def ont():
    return G.make_genome(_cfg("hs250-map-ont"), with_labels=True)


@pytest.fixture(scope="module")
def spliced():
    return G.make_genome(_cfg("hs250-splice"), with_labels=True)


def test_genome_is_the_same_from_its_seed(ont):
    again = G.make_genome(_cfg("hs250-map-ont"))
    assert all(np.array_equal(a, b) for a, b in zip(ont.codes, again.codes))
    other = _cfg("hs250-map-ont")
    other["genome"]["seed"] += 1
    diff = G.make_genome(other)
    assert not np.array_equal(ont.codes[0], diff.codes[0])


def test_repeat_shares_follow_the_configuration(ont):
    lab = np.concatenate(ont.labels)
    cfg = _cfg("hs250-map-ont")
    for i, fam in enumerate(cfg["genome"]["repeats"]):
        share = float((lab == 3 + i).mean())
        assert abs(share - fam["share"]) < 0.015, (fam["name"], share)
    sat = cfg["genome"]["satellite"]["array_bp"] // (171 * 12) * 171 * 12
    assert float((lab == 1).mean()) == pytest.approx(
        sat / cfg["chrom_bp"], rel=1e-9)
    gc = np.concatenate(ont.codes)
    assert abs(float(((gc == 1) | (gc == 2)).mean()) - 0.41) < 0.01


def test_line_copies_are_mostly_5prime_truncated():
    fam = _cfg("hs250-map-ont")["genome"]["repeats"][1]
    lens = G._copy_lengths(np.random.default_rng(1), fam, 20_000)
    full = float((lens == fam["consensus_bp"]).mean())
    assert 0.08 < full < 0.15
    assert np.median(lens) < 1500


def test_satellite_hor_copies_diverge_under_two_percent(ont):
    sat = _cfg("hs250-map-ont")["genome"]["satellite"]
    hor = sat["monomer_bp"] * sat["hor_monomers"]
    st, en = ont.satellites[0]
    arr = ont.codes[0][st:en]
    n = len(arr) // hor
    copies = arr[:n * hor].reshape(n, hor)
    pair = (copies[1:] != copies[:-1]).mean(1)
    assert pair.max() < 0.02 and pair.mean() > 0.002
    mono = copies[0].reshape(sat["hor_monomers"], sat["monomer_bp"])
    between = (mono[1:] != mono[:-1]).mean(1)
    assert between.min() > 0.15  # monomers of one HOR differ far more


def test_gene_models_have_human_like_exons_and_introns():
    g = _cfg("hs250-splice")["genome"]["genes"]
    g = copy.deepcopy(g)
    g["intron"]["max_bp"] = 200_000
    rng = np.random.default_rng(3)
    models = [G.gene_model(rng, g) for _ in range(4000)]
    ne = np.array([(len(m) + 1) // 2 for m in models])
    assert 8.0 < ne.mean() < 10.5 and ne.min() >= 1 and ne.max() <= 30
    internal = np.concatenate([m[2:-2:2] for m in models if len(m) > 3])
    assert 130 < internal.mean() < 160
    introns = np.concatenate([m[1::2] for m in models])
    assert 1300 < np.median(introns) < 1700 and introns.max() <= 200_000


def test_planted_introns_are_canonical(spliced):
    assert len(spliced.genes) == round(6.5 * 2) * 2
    for g in spliced.genes:
        chrom = spliced.codes[g.chrom]
        for s, e in g.introns:
            donor, acceptor = G.to_bytes(chrom[s:s + 2]), \
                G.to_bytes(chrom[e - 2:e])
            assert (donor, acceptor) == ((b"GT", b"AG") if g.strand == 0
                                         else (b"CT", b"AC"))
        st, en = spliced.satellites[g.chrom]
        assert g.exons[-1, 1] <= st or g.exons[0, 0] >= en
    strands = [g.strand for g in spliced.genes]
    assert 0 < sum(strands) < len(strands)


def test_genome_reads_are_the_same_from_the_seed_and_share_sizes(ont):
    mix = _mix("ont-r9-wgs", batch_bp=400_000)
    t = R.Traffic(ont, mix)
    a, b = t.batch(2**40 + 7, 0), t.batch(2**40 + 7, 0)
    assert a.seqs == b.seqs and a.names == b.names
    c = t.batch(-5, 0)
    assert a.seqs != c.seqs
    # every seed maps the same read lengths, in another order
    assert sorted(t.lens.tolist()) == sorted(
        (a.end - a.start).tolist()) == sorted((c.end - c.start).tolist())
    assert a.bases >= 0.9 * mix["batch_bp"]


def test_read_lengths_follow_the_mix():
    mix = _mix("ont-r9-wgs", batch_bp=200_000_000)
    lens = R.length_multiset(mix)
    assert 14_000 < np.median(lens) < 16_000
    assert lens.min() >= 1000 and lens.max() <= 100_000
    assert 17_000 < lens.mean() < 21_000
    sig = np.log(lens).std()
    assert abs(sig - 0.7) < 0.05


@pytest.mark.parametrize("err", [{"sub": 0.03, "ins": 0.0, "del": 0.0},
                                 {"sub": 0.0, "ins": 0.025, "del": 0.0},
                                 {"sub": 0.0, "ins": 0.0, "del": 0.025}])
def test_error_rates_follow_the_mix(err):
    rng = np.random.default_rng(9)
    temp = rng.integers(0, 4, 400_000).astype(np.uint8)
    out = R.mutate(np.random.default_rng(10), [temp.copy()], err)[0]
    n = len(temp)
    if err["sub"]:
        got = (np.frombuffer(out, np.uint8) != G.BASES[temp]).mean()
        assert abs(got - err["sub"]) < 0.002
    else:
        grow = (len(out) - n) / n
        want = err["ins"] - err["del"]
        assert abs(grow - want) < 0.002


def test_reads_inside_a_satellite_have_no_unique_origin(ont):
    mix = _mix("ont-r9-wgs", batch_bp=3_000_000)
    b = R.Traffic(ont, mix).batch(11, 0)
    for i in range(len(b.names)):
        st, en = ont.satellites[b.chrom[i]]
        inside = b.start[i] >= st and b.end[i] <= en
        assert b.unique[i] == (not inside)


def test_transcript_reads_are_truncated_exonic_and_stranded(spliced):
    mix = _mix("cdna-ont", batch_bp=60_000,
               errors={"sub": 0.0, "ins": 0.0, "del": 0.0})
    t = R.Traffic(spliced, mix)
    b = t.batch(12, 0)
    assert b.seqs == t.batch(12, 0).seqs
    planted = {(g.chrom, int(s), int(e)) for g in spliced.genes
               for s, e in g.introns}
    for i, seq in enumerate(b.seqs):
        chrom = spliced.codes[b.chrom[i]]
        bounds = [b.start[i]] + [x for iv in b.introns[i] for x in iv] + \
            [b.end[i]]
        pieces = [chrom[bounds[j]:bounds[j + 1]]
                  for j in range(0, len(bounds), 2)]
        fwd = np.concatenate(pieces)
        want = G.revcomp(fwd) if b.rev[i] else fwd
        assert seq == G.to_bytes(want)
        for s, e in b.introns[i]:
            assert (int(b.chrom[i]), int(s), int(e)) in planted
    # Zipf with exponent 1: the r-th most expressed gene has 1/r of the
    # first's weight
    w = np.sort(t.weights)[::-1]
    assert np.allclose(w / w[0], 1.0 / np.arange(1, len(w) + 1))
    assert math.isclose(w.sum(), 1.0)
    # each read keeps its transcript's 3' end, and 40-100% of it
    ends = {}
    for g in spliced.genes:
        tl = int((g.exons[:, 1] - g.exons[:, 0]).sum())
        key = ((g.chrom, int(g.exons[-1, 1]), 0) if g.strand == 0
               else (g.chrom, int(g.exons[0, 0]), 1))
        ends[key] = tl
    for i, seq in enumerate(b.seqs):
        key = ((int(b.chrom[i]), int(b.end[i]), 0) if key_plus(b, i, ends)
               else (int(b.chrom[i]), int(b.start[i]), 1))
        assert key in ends
        assert 0.4 * ends[key] - 1 <= len(seq) <= ends[key]


def key_plus(b, i, ends):
    return (int(b.chrom[i]), int(b.end[i]), 0) in ends
