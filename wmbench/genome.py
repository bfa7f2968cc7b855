"""The synthetic human-like reference: a configuration's deployment genome.

Made in memory from the configuration's own seed, the same on every run,
as a published assembly is.  It stands for the human genome cut to the
configuration's size and keeps its repeat shapes:

- random background at the configuration's GC share;
- interspersed repeat families (an Alu-like SINE, an L1-like LINE): copies
  of one random consensus each, on either strand, diverged from it by
  substitutions at a per-copy rate, the LINE's copies mostly 5'-truncated;
- one alpha-satellite-like array a chromosome: a higher-order repeat (HOR)
  of `hor_monomers` monomers, each a diverged copy of one family monomer,
  tiled with a per-copy divergence under the configuration's bound;
- optionally planted genes (exons, canonical GT..AG introns, either
  strand), whose exon bases are drawn anew so that transcripts are unique.

Codes are 0-3 for A, C, G, T (uint8).  Nothing here imports the program.
"""
from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

# A C G T; complement is 3 - code
BASES = np.frombuffer(b"ACGT", np.uint8)


@dataclass
class Gene:
    chrom: int
    strand: int  # 0: + (transcript reads the genome forward), 1: -
    exons: np.ndarray  # (n, 2) int64 genome [start, end), ascending

    @property
    def introns(self) -> np.ndarray:
        """(n - 1, 2) genome [start, end) of each intron, ascending."""
        return np.stack([self.exons[:-1, 1], self.exons[1:, 0]], 1)


@dataclass
class Genome:
    names: list
    codes: list  # one uint8 code array a chromosome
    satellites: list  # (start, end) of each chromosome's array
    genes: list = field(default_factory=list)
    labels: list | None = None  # per-base class (tests): see LABELS

    @property
    def size(self) -> int:
        return sum(len(c) for c in self.codes)


LABELS = {"background": 0, "satellite": 1, "exon": 2}  # families from 3


def background(rng, n: int, gc: float) -> np.ndarray:
    """n random codes with GC share gc (A = T, C = G)."""
    lut = np.empty(256, np.uint8)
    at = int(round(256 * (1 - gc) / 2))
    cg = (256 - 2 * at) // 2
    lut[:at] = 0
    lut[at:at + cg] = 1
    lut[at + cg:at + 2 * cg] = 2
    lut[at + 2 * cg:] = 3
    return lut[rng.integers(0, 256, n, dtype=np.uint8)]


def substitute(rng, codes: np.ndarray, rate) -> None:
    """Replace each code, with probability `rate` (a scalar or one a code),
    by one of the three other bases, in place."""
    hit = rng.random(len(codes), dtype=np.float32) < rate
    k = int(hit.sum())
    codes[hit] = (codes[hit] + rng.integers(1, 4, k, dtype=np.uint8)) & 3


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


def _ragged(lens: np.ndarray):
    """(owner, offset) of every element of consecutive runs of `lens`."""
    lens = lens.astype(np.int64)
    owner = np.repeat(np.arange(len(lens)), lens)
    starts = np.cumsum(lens) - lens
    return owner, np.arange(int(lens.sum()), dtype=np.int64) - starts[owner]


def _copy_lengths(rng, fam: dict, n: int) -> np.ndarray:
    L = fam["consensus_bp"]
    if fam.get("full_share", 1.0) >= 1.0:
        return np.full(n, L, np.int64)
    tr = fam["truncated"]
    lens = np.exp(rng.normal(math.log(tr["median_bp"]), tr["sigma"], n))
    lens = np.clip(lens, tr["min_bp"], L).astype(np.int64)
    lens[rng.random(n) < fam["full_share"]] = L
    return lens


def _mean_copy_bp(fam: dict) -> float:
    """Mean copy length, from a fixed-seed draw of the model."""
    return float(_copy_lengths(np.random.default_rng(0), fam, 200_000).mean())


def _placed_fractions(g: dict, chrom_bp: int) -> list:
    """Bases to place of each family, as a share of the genome, so that the
    expected share left after later families and the satellites overwrite
    their copies (random placement covers 1 - exp(-f)) is its `share`."""
    sat = g["satellite"]["array_bp"] / chrom_bp
    out, later = [], 1.0 - sat
    for fam in reversed(g["repeats"]):
        cover = fam["share"] / later
        out.append(-math.log(1.0 - cover))
        later *= 1.0 - cover
    return out[::-1]


def _plant_family(rng, chrom, fam: dict, cons, frac: float, mean_bp: float,
                  label, labels) -> None:
    n = int(round(frac * len(chrom) / mean_bp))
    lens = _copy_lengths(rng, fam, n)
    div = rng.uniform(*fam["divergence"], n).astype(np.float32)
    starts = rng.integers(0, len(chrom) - lens + 1)
    rev = rng.random(n) < 0.5
    owner, off = _ragged(lens)
    L = fam["consensus_bp"]
    rv = rev[owner]
    # a 5'-truncated copy keeps the consensus's 3' end; a reverse copy is
    # its reverse complement
    base = cons[np.where(rv, L - 1 - off, L - lens[owner] + off)]
    base[rv] = 3 - base[rv]
    substitute(rng, base, div[owner])
    pos = starts[owner] + off
    chrom[pos] = base
    if labels is not None:
        labels[pos] = label


def _plant_satellite(rng, chrom, sat: dict, mono, labels) -> tuple:
    hor = np.tile(mono, sat["hor_monomers"])
    substitute(rng, hor, sat["monomer_divergence"])
    n = sat["array_bp"] // len(hor)
    arr = np.tile(hor, n)
    div = rng.uniform(*sat["copy_divergence"], n).astype(np.float32)
    substitute(rng, arr, np.repeat(div, len(hor)))
    lo, hi = sat["position"]
    st = int(rng.integers(int(lo * len(chrom)), int(hi * len(chrom))))
    chrom[st:st + len(arr)] = arr
    if labels is not None:
        labels[st:st + len(arr)] = LABELS["satellite"]
    return st, st + len(arr)


def _lognormal(rng, d: dict, n: int) -> np.ndarray:
    v = np.exp(rng.normal(math.log(d["median_bp"]), d["sigma"], n))
    return np.clip(v, d["min_bp"], d["max_bp"]).astype(np.int64)


def gene_model(rng, g: dict) -> np.ndarray:
    """Exon and intron lengths of one gene, alternating from the 5' end of
    its transcript (exon, intron, exon, ...)."""
    ne = int(np.clip(round(math.exp(rng.normal(
        math.log(g["exons"]["median"]), g["exons"]["sigma"]))), 1,
        g["exons"]["max"]))
    if ne == 1:
        ex = _lognormal(rng, g["single_exon"], 1)
    else:
        ex = np.concatenate([_lognormal(rng, g["first_exon"], 1),
                             _lognormal(rng, g["internal_exon"], ne - 2),
                             _lognormal(rng, g["last_exon"], 1)])
    intr = _lognormal(rng, g["intron"], ne - 1)
    out = np.empty(2 * ne - 1, np.int64)
    out[0::2] = ex
    out[1::2] = intr
    return out


def _plant_genes(rng, ci: int, chrom, sat: tuple, g: dict, labels) -> list:
    genes = []
    n = int(round(g["per_mbp"] * len(chrom) / 1e6))
    models = [gene_model(rng, g) for _ in range(n)]
    spans_bp = np.array([m.sum() for m in models])
    # one gene's span is kept spare: a gene that would straddle the
    # satellite array starts past it, which loses at most that much
    free = (len(chrom) - (sat[1] - sat[0]) - int(spans_bp.sum())
            - int(spans_bp.max()))
    if free <= 0:
        raise ValueError("genes do not fit the chromosome")
    gaps = rng.dirichlet(np.ones(n + 1)) * free
    pos = 0
    for m, gap in zip(models, gaps[:-1]):
        pos += int(gap)
        if pos < sat[1] and pos + m.sum() > sat[0]:
            pos = sat[1]
        if pos + m.sum() > len(chrom):
            raise ValueError("genes do not fit the chromosome")
        strand = int(rng.random() < 0.5)
        lens = m if strand == 0 else m[::-1]
        bounds = pos + np.concatenate([[0], np.cumsum(lens)])
        exons = np.stack([bounds[0:-1:2], bounds[1::2]], 1)
        for s, e in exons:
            chrom[s:e] = background(rng, e - s, 0.46)
            if labels is not None:
                labels[s:e] = LABELS["exon"]
        for s, e in np.stack([exons[:-1, 1], exons[1:, 0]], 1):
            # GT..AG on the transcript's strand
            if strand == 0:
                chrom[s:s + 2] = (2, 3)
                chrom[e - 2:e] = (0, 2)
            else:
                chrom[s:s + 2] = (1, 3)
                chrom[e - 2:e] = (0, 1)
        genes.append(Gene(ci, strand, exons.astype(np.int64)))
        pos = int(bounds[-1])
    return genes


def make_genome(cfg: dict, with_labels: bool = False) -> Genome:
    """The configuration's genome: `chromosomes` of `chrom_bp` each, shaped
    by its "genome" section, from that section's seed.  The consensus
    sequences come from the seed's first stream, each chromosome from a
    stream of its own, so the chromosomes are made in threads and the
    genome does not depend on their order."""
    g = cfg["genome"]
    n, L = cfg["chromosomes"], cfg["chrom_bp"]
    seq = np.random.SeedSequence(g["seed"])
    main, *streams = seq.spawn(n + 1)
    rng = np.random.default_rng(main)
    fams = [(fam, background(rng, fam["consensus_bp"], g["gc"]),
             frac, _mean_copy_bp(fam))
            for fam, frac in zip(g["repeats"], _placed_fractions(g, L))]
    mono = background(rng, g["satellite"]["monomer_bp"], g["gc"])

    def one(ci):
        r = np.random.default_rng(streams[ci])
        chrom = background(r, L, g["gc"])
        lab = np.zeros(L, np.uint8) if with_labels else None
        for i, (fam, cons, frac, mean_bp) in enumerate(fams):
            _plant_family(r, chrom, fam, cons, frac, mean_bp, 3 + i, lab)
        sat = _plant_satellite(r, chrom, g["satellite"], mono, lab)
        genes = (_plant_genes(r, ci, chrom, sat, g["genes"], lab)
                 if g.get("genes") else [])
        return chrom, lab, sat, genes

    with ThreadPoolExecutor(min(n, 8)) as ex:
        parts = list(ex.map(one, range(n)))
    return Genome([f"chr{i + 1}" for i in range(n)],
                  [p[0] for p in parts], [p[2] for p in parts],
                  [x for p in parts for x in p[3]],
                  [p[1] for p in parts] if with_labels else None)


def to_bytes(codes: np.ndarray) -> bytes:
    return BASES[codes].tobytes()
