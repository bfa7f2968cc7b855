"""Genome-scale run of the port: count, index and map against a synthetic
genome of about a Gbp on the card, with every result held to a check.

The port of tests/tools/scale_run.py.  The corpus is the JAX tool's, byte
for byte, from the same seed: a genome of max(1, n // 250 Mbp)
chromosomes, each with eight tandem-repeat arrays of 50 copies of a
400-base unit, and reads of read_len +- read_len / 3 bases at 8%
substitutions from either strand, named read{i}_chr{c}_{pos}_{strand}.
Then, on `device` (None: the card, which raises when there is none;
"cpu": the kernels' plain versions):

  1. count: the genome's canonical 15-mers through kcount.count_kmers
     (KC block by block, the runs merged on the host; --mem-gb asks for
     the host's memory-bounded counter instead), the distinct=0.9998
     threshold and the -W list of the k-mers above it (scale_rep.txt);
  2. index: build_index with the list (S1, one launch a SKETCH_MAX_CODES
     of records), held array for array to a native build of the same
     records;
  3. map: map_batch with -c (MM_F_CIGAR | MM_F_OUT_CG), every DP job
     through K1 and K2, the PAF written by pipeline._write_read
     (scale_ours.paf); a second pass must give the same PAF;
  4. checks: on the card, the median-rows call of each launch K1 took,
     run again through K1 and K2 and their plain versions
     (extend/check.hold_call), exactly equal, S1 launched once a launch
     group and KC once a block of at least k codes; no DP job on the
     engine's host DP;
     each read's primary hit on its origin (chromosome, strand and an
     overlap with the sampled interval) for at least MIN_ORIGIN of the
     reads, each read that misses named.

A failed check raises ScaleCheckFailed and main() exits 1.  The last line
is the SCALE-SUMMARY line (the JAX tool's fields, and the card's name and
power limit, the launches of S1, KC, K1, K2 and C1, the peak device GiB
reserved and the peak host RSS).

--oracle names a reference winnowmap binary for the JAX tool's
differential (sorted PAF lines, and every alignment field but the chain
statistics cm, s1, s2 and the reference's uninitialised rl); the
repository ships none, and the run neither needs it nor looks for one
when it is not given.

Usage:
  python -m winnowmap_tpu_torch.tools.scale_run [--gbp 1.0]
      [--n-reads 200] [--read-len 15000] [--workdir DIR] [--seed 11]
      [--mem-gb G] [--oracle PATH] [--device cuda|cpu]

At 1.0 Gbp on an H100 the run takes tens of minutes, most of it the count's
host merge; the corpus and its files stay in --workdir
(smoke_data/scale under the repository by default, which git ignores),
and a later run reuses the corpus only if it was made from the same
--gbp, --n-reads, --read-len and --seed (scale_corpus.json says which).
"""
from __future__ import annotations

import argparse
import hashlib
import io
import json
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..chain import device as CD
from ..device import resolve_device
from ..extend import check as XC
from ..extend import kernels as K
from ..index.build import _launch_groups, build_index, load_weight_set
from ..io.fastx import read_all
from ..kcount import count_kmers
from ..kcount import device as KD
from ..map.batch import STATS, map_batch
from ..map.pipeline import _write_read
from ..options import (MM_F_CIGAR, MM_F_OUT_CG, IndexOptions, MapOptions,
                       update_mid_occ)
from ..sketch import device as SD
from . import card_line

REPO = Path(__file__).resolve().parent.parent.parent
WORKDIR = REPO / "smoke_data" / "scale"
# written beside the corpus once its files are whole: what it was made for
CORPUS_STAMP = "scale_corpus.json"
K_COUNT = 15
DISTINCT = 0.9998
# the least share of reads whose primary hit lies on their origin: a read
# wholly inside a tandem-repeat array maps equally along it, and the arrays
# are 0.06% of a 1 Gbp genome
MIN_ORIGIN = 0.98
FASTA_WIDTH = 80
ACGT = np.frombuffer(b"ACGT", np.uint8)
# A C G T -> 0 1 2 3, as the JAX tool's read sampling encodes
_CODE = np.zeros(256, np.uint8)
_CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


class ScaleCheckFailed(RuntimeError):
    """A check of the run failed."""


def rss_gb() -> float:
    """The process's peak resident set, GB (ru_maxrss is in KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def log(msg):
    print(f"[scale {time.strftime('%H:%M:%S')} rss={rss_gb():.1f}G] {msg}",
          flush=True)


def fasta_lines(s: bytes, width: int = FASTA_WIDTH) -> bytes:
    """s cut into lines of `width` bases, each ended by a newline."""
    full = len(s) // width
    body = np.empty((full, width + 1), np.uint8)
    body[:, :width] = np.frombuffer(s, np.uint8,
                                    full * width).reshape(full, width)
    body[:, width] = ord("\n")
    tail = s[full * width:]
    return body.tobytes() + (tail + b"\n" if tail else b"")


def genome_shape(gbp: float):
    """(chromosomes, bases a chromosome) of make_corpus's genome."""
    n = int(gbp * 1e9)
    n_chrom = max(1, n // 250_000_000)
    return n_chrom, n // n_chrom


def make_corpus(workdir: Path, gbp: float, n_reads: int, read_len: int,
                seed: int):
    """scale_ref.fa and scale_reads.fa in workdir, byte-equal to the JAX
    tool's from the same arguments (the same numpy default_rng calls in the
    same order).  The files already there are reused only when the stamp
    written after them (CORPUS_STAMP) names the same genome size, reads,
    read length and seed; else they are made anew.  Returns their paths."""
    ref = workdir / "scale_ref.fa"
    reads = workdir / "scale_reads.fa"
    stamp = workdir / CORPUS_STAMP
    n_chrom, per = genome_shape(gbp)
    want = {"bases": n_chrom * per, "n_reads": n_reads,
            "read_len": read_len, "seed": seed}
    if ref.exists() and reads.exists() and stamp.exists():
        have = json.loads(stamp.read_text())
        if have == want:
            log("corpus present, reusing")
            return ref, reads
        log(f"corpus present for {have}, not {want}: making it anew")
    stamp.unlink(missing_ok=True)
    rng = np.random.default_rng(seed)
    log(f"generating {n_chrom * per / 1e9:.2f} Gbp genome ({n_chrom} "
        f"chroms)")
    chroms = []
    with open(ref, "wb") as f:
        for c in range(n_chrom):
            g = rng.integers(0, 4, per).astype(np.uint8)
            # tandem-repeat arrays to exercise the down-weighting
            for _ in range(8):
                unit = rng.integers(0, 4, 400).astype(np.uint8)
                arr = np.tile(unit, 50)
                p = int(rng.integers(0, per - len(arr)))
                g[p:p + len(arr)] = arr
            s = ACGT[g].tobytes()
            del g
            chroms.append(s)
            f.write(f">chr{c + 1}\n".encode())
            f.write(fasta_lines(s))
            log(f"chr{c + 1} written ({per / 1e6:.0f} Mbp)")
    log("sampling reads")
    with open(reads, "wb") as f:
        for i in range(n_reads):
            c = int(rng.integers(0, n_chrom))
            L = int(read_len + rng.integers(-read_len // 3, read_len // 3))
            p = int(rng.integers(0, per - L))
            code = _CODE[np.frombuffer(chroms[c], np.uint8, L, p)]
            m = rng.random(L) < 0.08
            code[m] = (code[m] + rng.integers(1, 4, int(m.sum()))) % 4
            rc = bool(rng.integers(0, 2))
            if rc:
                code = 3 - code[::-1]
            f.write(f">read{i}_chr{c + 1}_{p}_{'-' if rc else '+'}\n"
                    .encode())
            f.write(ACGT[code].tobytes() + b"\n")
    stamp.write_text(json.dumps(want))
    return ref, reads


def read_origin(name: str):
    """(chromosome, position, strand) of a read named
    read{i}_chr{c}_{pos}_{strand} by make_corpus."""
    _, chrom, pos, strand = name.rsplit("_", 3)
    if strand not in "+-" or len(strand) != 1:
        raise ValueError(f"{name!r} is not a read name of make_corpus")
    return chrom, int(pos), strand


def origin_misses(paf_text: str, names) -> list[str]:
    """The reads (of `names`, in order) whose primary hit in the PAF (the
    first line of the read with tp:A:P, or its first line when it has no
    tp tag) is not on its simulated origin: the same chromosome and strand,
    and [ts, te) overlapping [pos, pos + qlen).  A read without a line
    misses."""
    primary = {}
    for ln in paf_text.splitlines():
        f = ln.split("\t")
        tp = [t for t in f[12:] if t.startswith("tp:A:")]
        if f[0] in primary or (tp and tp[0] != "tp:A:P"):
            continue
        primary[f[0]] = f
    out = []
    for nm in names:
        f = primary.get(nm)
        chrom, pos, strand = read_origin(nm)
        if f is None or f[5] != chrom or f[4] != strand \
                or not (int(f[7]) < pos + int(f[1]) and int(f[8]) > pos):
            out.append(nm)
    return out


def paf_text(mi, mo, recs, results) -> str:
    out = io.StringIO()
    for rec, res in zip(recs, results):
        _write_read(mi, mo, rec, res, out)
    return out.getvalue()


def oracle_differential(oracle: str, rep: Path, ref: Path, reads: Path,
                        ours: Path, ref_out: Path, summary: dict) -> None:
    """The JAX tool's differential against the reference binary's PAF
    (run once into ref_out, -t 1 -c -W rep)."""
    if not ref_out.exists():
        t0 = time.time()
        log("running reference oracle")
        with open(ref_out, "w") as f:
            subprocess.run([oracle, "-t", "1", "-c", "-W", str(rep),
                            str(ref), str(reads)], stdout=f,
                           stderr=subprocess.DEVNULL, check=True,
                           timeout=14400)
        summary["oracle_s"] = round(time.time() - t0, 1)
    a = sorted(ours.read_text().splitlines())
    b = sorted(ref_out.read_text().splitlines())
    summary["paf_lines_ours"] = len(a)
    summary["paf_lines_ref"] = len(b)
    summary["paf_lines_equal"] = sum(1 for x, y in zip(a, b) if x == y)

    # the exact set against the reference's bloom filter moves the chain
    # statistics (cm, s1) and the reference leaves rl uninitialised; the
    # alignment itself (coordinates, CIGAR, NM, AS, MAPQ) must match
    def _norm(lines):
        drop = ("cm", "s1", "s2", "rl")
        return sorted("\t".join(f[:12] + [t for t in f[12:]
                                          if t.split(":")[0] not in drop])
                      for f in (ln.split("\t") for ln in lines))

    an, bn = _norm(a), _norm(b)
    summary["paf_alnfields_equal"] = sum(1 for x, y in zip(an, bn)
                                         if x == y)
    log(f"differential: {summary['paf_lines_equal']}/{max(len(a), len(b))} "
        f"identical lines; {summary['paf_alnfields_equal']} identical in "
        f"all alignment fields")


class _Phase:
    """Seconds, launch counts (zeroed just before, read just after) and,
    on the card, the peak device GiB reserved of one phase."""

    def __init__(self, dev, counters):
        self.dev, self.counters = dev, counters

    def __enter__(self):
        for c in self.counters:
            for k in c:
                c[k] = 0
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.s = time.perf_counter() - self.t0
        self.launches = {k: v for c in self.counters for k, v in c.items()}
        self.peak_gib = (torch.cuda.max_memory_reserved(self.dev) / 2**30
                         if self.dev.type == "cuda" else 0.0)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise ScaleCheckFailed(what)
    log(f"check passed: {what}")


def run(workdir=WORKDIR, gbp: float = 1.0, n_reads: int = 200,
        read_len: int = 15000, seed: int = 11, mem_gb: float | None = None,
        oracle: str | None = None, device=None) -> dict:
    """The genome-scale run on `device` (None: the card): make the corpus,
    count, index and map it twice, and check each step (the module's
    docstring).  Returns the summary; raises ScaleCheckFailed when a check
    fails."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    wd = Path(workdir)
    wd.mkdir(parents=True, exist_ok=True)
    summary = {"device": str(dev)}
    if on_card:
        summary["card"] = card_line()
        log(f"card: {summary['card']}")
    ref, reads = make_corpus(wd, gbp, n_reads, read_len, seed)
    records = read_all(str(ref))
    rd = read_all(str(reads))
    genome_bp = sum(len(r.seq) for r in records)
    log(f"{len(records)} records, {genome_bp} bases")
    n_chrom, per = genome_shape(gbp)
    check(len(records) == n_chrom and genome_bp == n_chrom * per
          and len(rd) == n_reads,
          f"the corpus is the one asked for ({n_chrom} x {per} bases, "
          f"{n_reads} reads)")

    # ---- k-mer counting: KC block by block, or the host counter --------
    rep = wd / "scale_rep.txt"
    log("counting k-mers" + (f" (host counter, {mem_gb} GB)" if mem_gb
                             else " (KC)"))
    with _Phase(dev, [KD.LAUNCHES]) as ph:
        kc = count_kmers(records, K_COUNT, device=dev,
                         max_memory_bytes=(None if mem_gb is None
                                           else int(mem_gb * 1e9)))
        thr = kc.threshold_distinct(DISTINCT)
        over = kc.greater_than(thr)
        with open(rep, "w") as f:
            for line in over.print_lines():
                f.write(line + "\n")
    summary.update(count_s=round(ph.s, 1), threshold=thr,
                   distinct_kmers=kc.n_distinct, rep_kmers=over.n_distinct,
                   count_peak_dev_gib=round(ph.peak_gib, 3))
    kc_launches = ph.launches["kcount"]
    del kc, over
    log(f"counting done in {summary['count_s']} s, threshold {thr}, "
        f"{summary['rep_kmers']} k-mers listed, {kc_launches} KC launches")
    if on_card and mem_gb is None:
        blocks = sum(1 for b in KD.iter_code_blocks(records, K_COUNT)
                     if len(b) >= K_COUNT)
        check(kc_launches == blocks,
              f"KC launched once a block ({kc_launches} of {blocks})")

    # ---- index through S1, held to the native build --------------------
    io_, mo = IndexOptions(), MapOptions()
    mo.flag |= MM_F_CIGAR | MM_F_OUT_CG  # like the CLI's -c
    wset = load_weight_set(str(rep), io_.k)
    with _Phase(dev, [SD.LAUNCHES]) as ph:
        mi = build_index(records, io_.w, io_.k, io_.flag, wset, device=dev)
        update_mid_occ(mo, mi)
    s1_launches = ph.launches["sketch"]
    summary.update(index_s=round(ph.s, 1), n_minimizers=int(len(mi.pos)),
                   index_peak_dev_gib=round(ph.peak_gib, 3))
    log(f"index built in {summary['index_s']} s "
        f"({summary['n_minimizers'] / 1e6:.1f} M minimizers, {s1_launches} "
        f"S1 launches)")
    if on_card:
        groups = len(_launch_groups(mi.seqs))
        check(s1_launches == groups,
              f"S1 launched once a launch group ({s1_launches} of {groups})")
    t0 = time.perf_counter()
    nat = build_index(records, io_.w, io_.k, io_.flag, wset,
                      sketch_min_bp=None)
    summary["native_index_s"] = round(time.perf_counter() - t0, 1)
    check(all(np.array_equal(getattr(mi, a), getattr(nat, a))
              for a in ("keys", "start", "pos")),
          f"the index equals the native build's keys, start and pos "
          f"(native build {summary['native_index_s']} s)")
    del nat, records

    # ---- mapping, twice --------------------------------------------------
    seqs, names = [r.seq for r in rd], [r.name for r in rd]
    STATS.clear()
    with _Phase(dev, [K.LAUNCHES, CD.LAUNCHES]) as ph, \
            XC.CallRecorder("extd") as rec:
        results = map_batch(mi, mo, seqs, names, device=dev)
    launches = dict(ph.launches)
    host_dp = int(STATS.get("eng_host_dp_calls", 0))
    summary.update(map_s=round(ph.s, 1),
                   reads_per_s=round(len(rd) / ph.s, 2),
                   eng_host_dp_calls=host_dp,
                   map_peak_dev_gib=round(ph.peak_gib, 3))
    text = paf_text(mi, mo, rd, results)
    ours = wd / "scale_ours.paf"
    ours.write_text(text)
    digest = hashlib.sha256(text.encode()).hexdigest()
    log(f"mapped {len(rd)} reads in {summary['map_s']} s, launches "
        f"{launches}, PAF sha256 {digest[:16]}")
    check(host_dp == 0, "no DP job on the engine's host DP "
                        "(eng_host_dp_calls 0)")
    with _Phase(dev, []) as ph2:
        again = paf_text(mi, mo, rd, map_batch(mi, mo, seqs, names,
                                               device=dev))
    summary["map2_s"] = round(ph2.s, 1)
    check(hashlib.sha256(again.encode()).hexdigest() == digest,
          f"a second pass gives the same PAF ({summary['map2_s']} s)")
    if on_card:
        check(launches["extd"] > 0 and launches["traceback"] > 0,
              "K1 and K2 launched")

    # ---- K1 and K2 held to their plain versions (on the CPU the wrappers
    # are the plain versions: nothing to hold) ----------------------------
    if on_card:
        t0 = time.perf_counter()
        held = {}
        for path, rows, c in rec.picks():
            t1 = time.perf_counter()
            check(XC.hold_call(c, "extd", rows),
                  f"K1 and K2 == plain on the median-rows call of launch "
                  f"{path} ({c['jobs'].shape[0]} jobs, {rows} rows)")
            held[path] = [int(c["jobs"].shape[0]), rows,
                          round(time.perf_counter() - t1, 1)]
        summary["held"] = held
        summary["hold_s"] = round(time.perf_counter() - t0, 1)
    del rec

    # ---- origin of each read's primary hit -----------------------------
    misses = origin_misses(text, names)
    for nm in misses:
        log(f"read off its origin: {nm}")
    share = 1 - len(misses) / max(1, len(names))
    summary["origin_share"] = round(share, 4)
    check(share >= MIN_ORIGIN, f"{share:.2%} of the reads' primary hits on "
                               f"their origin (at least {MIN_ORIGIN:.0%})")

    if oracle:
        oracle_differential(oracle, rep, ref, reads, ours,
                            wd / "scale_ref.paf", summary)
    summary["launches"] = {
        "sketch": s1_launches, "kcount": kc_launches,
        "extd": launches["extd"], "traceback": launches["traceback"],
        "chain_fwd": launches["chain_fwd"]}
    summary["genome_bp"] = genome_bp
    summary["peak_dev_gib"] = max(summary[f"{p}_peak_dev_gib"]
                                  for p in ("count", "index", "map"))
    summary["peak_rss_gb"] = round(rss_gb(), 2)
    return summary


def summary_line(summary: dict) -> str:
    """The SCALE-SUMMARY line: key=value by key, a value that is not a
    number as compact JSON."""
    def val(v):
        if isinstance(v, (int, float)):
            return v
        return json.dumps(v, separators=(",", ":"))

    return "SCALE-SUMMARY " + " ".join(f"{k}={val(v)}"
                                       for k, v in sorted(summary.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Count, index and map a synthetic genome of --gbp Gbp "
                    "on the card, with every result checked.")
    ap.add_argument("--gbp", type=float, default=1.0)
    ap.add_argument("--n-reads", type=int, default=200)
    ap.add_argument("--read-len", type=int, default=15000)
    ap.add_argument("--workdir", default=str(WORKDIR))
    ap.add_argument("--oracle", default=None,
                    help="a reference winnowmap binary for the PAF "
                         "differential (optional; the repository ships "
                         "none and the run does not need it)")
    ap.add_argument("--mem-gb", type=float, default=None,
                    help="count with the host's memory-bounded counter "
                         "under this budget instead of KC on the device")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    a = ap.parse_args(argv)
    try:
        summary = run(a.workdir, a.gbp, a.n_reads, a.read_len, a.seed,
                      a.mem_gb, a.oracle, a.device)
    except ScaleCheckFailed as e:
        log(f"CHECK FAILED: {e}")
        return 1
    print(summary_line(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
