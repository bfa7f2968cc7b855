"""The one traffic generator: read batches from a traffic mix's parameters.

A mix (`wmbench/traffic/<mix>.json`) names its `source`:

- "genome": whole-genome reads.  Lengths are log-normal (median, sigma,
  clipped); placement is uniform over the genome and both strands,
  satellites included.
- "transcripts": cDNA reads of the configuration's planted genes.
  Expression is Zipf-skewed over genes; each read keeps the transcript's
  3' end, cut at the 5' end to a uniform share of its length, and is read
  on either strand.

Errors are substitutions, insertions and deletions at the mix's rates,
independent a base.  A batch holds reads until `batch_bp` bases are
reached (the last read crosses it), so a reader with `-K batch_bp` takes
the file in one batch.

The work is fixed by the mix, not by --seed: batch i of the pool holds
the same loci (genome reads: each read's length, chromosome and start,
one length multiset a batch) or the same transcripts (cDNA: gene and kept
share, genes expressed by a fixed tissue) for every seed, all drawn from
the mix's `sizes_seed`.  --seed draws the reads' order, strand, errors and
a shift of each genome read's start by up to `jitter_bp`, so every seed
maps the same amount of work in another arrangement.  Nothing here
imports the program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .genome import BASES, Genome, revcomp


@dataclass
class Batch:
    """One file's worth of reads and what the generator knows of each."""
    names: list
    seqs: list  # bytes, as written
    chrom: np.ndarray  # origin chromosome
    start: np.ndarray  # origin genome interval [start, end)
    end: np.ndarray
    rev: np.ndarray  # the read is the reverse complement of the genome
    unique: np.ndarray  # False: wholly inside a satellite array
    introns: list  # transcripts: (m, 2) planted introns the read spans

    @property
    def bases(self) -> int:
        return sum(len(s) for s in self.seqs)

    def fasta(self) -> bytes:
        return b"".join(b">%s\n%s\n" % (n.encode(), s)
                        for n, s in zip(self.names, self.seqs))


def stream(seed: int, *path: int) -> np.random.Generator:
    """A generator for (seed, path...): any whole number seed, negatives
    and numbers past 64 bits included."""
    words = [seed % (1 << 64), seed // (1 << 64) % (1 << 64),
             int(seed < 0)]
    return np.random.default_rng(np.random.SeedSequence(words + list(path)))


def mutate(rng, templates: list, err: dict) -> list:
    """Each template (codes) with substitutions, deletions and insertions
    at err's rates, a base at a time; returns bytes."""
    lens = np.array([len(t) for t in templates], np.int64)
    base = np.concatenate(templates)
    u = rng.random(len(base), dtype=np.float32)
    ps, pd, pi = err["sub"], err["del"], err["ins"]
    sub = u < ps
    base[sub] = (base[sub] + rng.integers(1, 4, int(sub.sum()),
                                          dtype=np.uint8)) & 3
    dele = (u >= ps) & (u < ps + pd)
    ins = (u >= ps + pd) & (u < ps + pd + pi)
    cnt = 1 - dele.astype(np.int64) + ins
    out = np.repeat(base, cnt)
    first = np.cumsum(cnt) - cnt
    at = first[ins] + 1
    out[at] = rng.integers(0, 4, len(at), dtype=np.uint8)
    owner_end = np.cumsum(lens)
    out_ends = np.cumsum(cnt)[owner_end - 1] if len(base) else owner_end
    letters = BASES[out].tobytes()
    starts = np.concatenate([[0], out_ends[:-1]])
    return [letters[s:e] for s, e in zip(starts, out_ends)]


def length_multiset(mix: dict) -> np.ndarray:
    """One batch's read lengths, drawn from the mix's sizes_seed."""
    d = mix["length"]
    rng = stream(mix["sizes_seed"])
    out, total = [], 0
    while total < mix["batch_bp"]:
        n = int(math.exp(rng.normal(math.log(d["median_bp"]), d["sigma"])))
        n = min(max(n, d["min_bp"]), d["max_bp"])
        out.append(n)
        total += n
    return np.array(out, np.int64)


def genome_layout(genome: Genome, mix: dict, index: int, lens):
    """Batch `index`'s loci, fixed by the mix's sizes_seed: (chrom,
    start) of each read of the length multiset, uniform over the
    genome."""
    rng = stream(mix["sizes_seed"], index)
    lens = rng.permutation(lens)
    sizes = np.array([len(c) for c in genome.codes], np.int64)
    chrom = rng.choice(len(sizes), len(lens), p=sizes / sizes.sum())
    start = (rng.random(len(lens)) * (sizes[chrom] - lens + 1)).astype(
        np.int64)
    return lens, chrom, start


def genome_batch(genome: Genome, mix: dict, rng, layout,
                 tag: str) -> Batch:
    """The layout's reads as --seed draws them: each start moved by up
    to jitter_bp, either strand, in a new order, with new errors."""
    lens, chrom, start = layout
    order = rng.permutation(len(lens))
    lens, chrom, start = lens[order], chrom[order], start[order]
    sizes = np.array([len(c) for c in genome.codes], np.int64)
    j = mix.get("jitter_bp", 0)
    start = np.clip(start + rng.integers(-j, j + 1, len(lens)), 0,
                    sizes[chrom] - lens)
    end = start + lens
    rev = rng.random(len(lens)) < 0.5
    temps = []
    for c, s, e, r in zip(chrom, start, end, rev):
        t = genome.codes[c][s:e]
        temps.append(revcomp(t) if r else t.copy())
    sat = np.array(genome.satellites, np.int64)[chrom]
    unique = ~((start >= sat[:, 0]) & (end <= sat[:, 1]))
    seqs = mutate(rng, temps, mix["errors"])
    names = [f"{tag}_{i}" for i in range(len(lens))]
    return Batch(names, seqs, chrom, start, end, rev, unique,
                 [np.zeros((0, 2), np.int64)] * len(lens))


def tissue(genome: Genome, mix: dict) -> np.ndarray:
    """Each gene's expression weight: Zipf over ranks, the ranks a fixed
    permutation of the genes drawn from the mix's sizes_seed."""
    n = len(genome.genes)
    if n == 0:
        raise ValueError("transcript traffic needs a configuration with "
                         "planted genes")
    rank = stream(mix["sizes_seed"]).permutation(n) + 1
    w = 1.0 / rank.astype(np.float64) ** mix["expression"]["zipf"]
    return w / w.sum()


def transcript_layout(genome: Genome, mix: dict, index: int, weights):
    """Batch `index`'s transcripts, fixed by the mix's sizes_seed: a gene
    drawn by expression and the share of it kept, for each read, until
    batch_bp bases."""
    rng = stream(mix["sizes_seed"], index)
    lo, hi = mix["truncation"]
    out, total = [], 0
    while total < mix["batch_bp"]:
        g = int(rng.choice(len(weights), p=weights))
        ex = genome.genes[g].exons
        tlen = int((ex[:, 1] - ex[:, 0]).sum())
        keep = max(1, int(round(tlen * rng.uniform(lo, hi))))
        out.append((g, keep))
        total += keep
    return out


def transcript_batch(genome: Genome, mix: dict, rng, layout,
                     tag: str) -> Batch:
    """The layout's transcripts as --seed draws them: in a new order, on
    either strand, with new errors."""
    temps, chrom, start, end, rev, introns = [], [], [], [], [], []
    for k in rng.permutation(len(layout)):
        gi, keep = layout[k]
        g = genome.genes[gi]
        ex = g.exons
        elen = ex[:, 1] - ex[:, 0]
        tlen = int(elen.sum())
        codes = genome.codes[g.chrom]
        # the kept 3' part in genome order
        if g.strand == 0:
            cum = np.cumsum(elen) - elen  # transcript offset of each exon
            t0 = tlen - keep
            i = int(np.searchsorted(cum, t0, side="right") - 1)
            gs = int(ex[i, 0] + (t0 - cum[i]))
            pieces = [(gs, int(ex[i, 1]))] + [
                (int(s), int(e)) for s, e in ex[i + 1:]]
        else:
            # the transcript's 3' end is the genome-leftmost exon's start
            cum = np.cumsum(elen)  # genome-order bases up to exon end
            i = int(np.searchsorted(cum, keep, side="left"))
            ge = int(ex[i, 1] - (cum[i] - keep))
            pieces = [(int(s), int(e)) for s, e in ex[:i]] + [
                (int(ex[i, 0]), ge)]
        seq = np.concatenate([codes[s:e] for s, e in pieces])
        sense = seq if g.strand == 0 else revcomp(seq)
        flip = bool(rng.random() < 0.5)
        temps.append(revcomp(sense) if flip else sense.copy())
        chrom.append(g.chrom)
        start.append(pieces[0][0])
        end.append(pieces[-1][1])
        # the read is the genome's reverse complement when the gene's
        # strand and the read's flip differ
        rev.append(bool(g.strand) != flip)
        introns.append(np.array([(pieces[j][1], pieces[j + 1][0])
                                 for j in range(len(pieces) - 1)],
                                np.int64).reshape(-1, 2))
    seqs = mutate(rng, temps, mix["errors"])
    n = len(temps)
    return Batch([f"{tag}_{i}" for i in range(n)], seqs, np.array(chrom),
                 np.array(start, np.int64), np.array(end, np.int64),
                 np.array(rev), np.ones(n, bool), introns)


class Traffic:
    """A mix over one genome: batch(seed, index) is deterministic; batch
    `index`'s loci (genome reads) or transcripts (cDNA) are the same for
    every seed."""

    def __init__(self, genome: Genome, mix: dict):
        self.genome = genome
        self.mix = mix
        self.layouts = {}
        if mix["source"] == "genome":
            self.lens = length_multiset(mix)
        elif mix["source"] == "transcripts":
            self.weights = tissue(genome, mix)
        else:
            raise ValueError(f"unknown traffic source {mix['source']!r}")

    def layout(self, index: int, scale: float):
        key = (index, scale)
        if key not in self.layouts:
            if self.mix["source"] == "genome":
                lens = self.lens
                if scale < 1.0:
                    lens = lens[:max(1, int(len(lens) * scale))]
                self.layouts[key] = genome_layout(self.genome, self.mix,
                                                  index, lens)
            else:
                mix = dict(self.mix,
                           batch_bp=int(self.mix["batch_bp"] * scale))
                self.layouts[key] = transcript_layout(self.genome, mix,
                                                      index, self.weights)
        return self.layouts[key]

    def batch(self, seed: int, index: int, scale: float = 1.0) -> Batch:
        """Batch `index` of --seed `seed`; `scale` < 1 gives a smaller batch
        of the same mix (the warm-up's)."""
        rng = stream(seed, index, int(scale < 1.0))
        tag = f"s{index}" if scale >= 1.0 else f"w{index}"
        lay = self.layout(index, scale)
        if self.mix["source"] == "genome":
            return genome_batch(self.genome, self.mix, rng, lay, tag)
        return transcript_batch(self.genome, self.mix, rng, lay, tag)
