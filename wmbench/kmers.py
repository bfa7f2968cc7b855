"""The `-W` list: Winnowmap's documented recipe, in the benchmark's NumPy.

    meryl count k=15 output merylDB ref.fa
    meryl print greater-than distinct=0.9998 merylDB > repetitive_k15.txt

(Winnowmap README, usage.)  Every canonical k-mer of the genome is counted
(the smaller of a k-mer's code and its reverse complement's, A C G T as
0-3); `distinct=f` is the count at which the running total of distinct
k-mers, in order of count, first reaches f of them (meryl's
merylOp-nextMer.C), and the list is every k-mer counted more often.  The
list is computed on a cell's first run in a checkout and kept in
`wmbench/.cache/`, keyed by the configuration file and the sources that
make it; later runs read it.  Nothing here imports the program.
"""
from __future__ import annotations

import hashlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .genome import BASES

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"


def canonical_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """Canonical codes of every k-mer of one sequence of codes 0-3
    (k <= 16: uint32)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint32)
    c = codes.astype(np.uint32)
    fwd = np.zeros(n, np.uint32)
    rev = np.zeros(n, np.uint32)
    for j in range(k):
        fwd <<= 2
        fwd |= c[j:j + n]
        rev |= (3 - c[j:j + n]) << np.uint32(2 * j)
    return np.minimum(fwd, rev)


def count(chroms, k: int):
    """(sorted distinct canonical k-mers, their counts) over all
    chromosomes."""
    if k > 16:
        raise ValueError("the benchmark's counter takes k <= 16")
    with ThreadPoolExecutor(min(len(chroms), 8)) as ex:
        parts = list(ex.map(lambda c: np.sort(canonical_kmers(c, k)),
                            chroms))
    keys = np.concatenate(parts)
    del parts
    keys.sort()
    head = np.flatnonzero(np.diff(keys)) + 1
    starts = np.concatenate([[0], head])
    counts = np.diff(np.concatenate([starts, [len(keys)]]))
    return keys[starts], counts


def threshold_distinct(counts: np.ndarray, frac: float) -> int:
    """The count at which `frac` of the distinct k-mers are covered, in
    order of count (meryl print ... distinct=frac)."""
    hist = np.bincount(counts)
    vals = np.flatnonzero(hist)
    acc = np.cumsum(hist[vals])
    idx = min(int(np.searchsorted(acc, int(frac * len(counts)))),
              len(vals) - 1)
    return int(vals[idx])


def kmer_text(keys: np.ndarray, counts: np.ndarray, k: int) -> bytes:
    """meryl print's lines: KMER<TAB>count."""
    shifts = np.arange(2 * (k - 1), -1, -2, dtype=np.uint32)
    letters = BASES[(keys[:, None] >> shifts) & 3]
    lines = [letters[i].tobytes() + b"\t%d\n" % int(c)
             for i, c in enumerate(counts)]
    return b"".join(lines)


def repetitive_list(keys, counts, k: int, frac: float) -> bytes:
    thr = threshold_distinct(counts, frac)
    m = counts > thr
    return kmer_text(keys[m], counts[m], k)


def cache_path(cfg_file: Path, k: int) -> Path:
    """The list's file for this configuration, keyed by the configuration
    file and the sources that make the genome and the list."""
    h = hashlib.sha256(Path(cfg_file).read_bytes())
    for src in ("genome.py", "kmers.py"):
        h.update((HERE / src).read_bytes())
    return CACHE / f"{Path(cfg_file).stem}-{h.hexdigest()[:16]}" / \
        f"repetitive_k{k}.txt"


def weight_list(cfg: dict, cfg_file: Path, genome) -> tuple[Path, bool]:
    """The configuration's list file, made now if the cache lacks it.
    Returns (path, made)."""
    wl = cfg["weight_list"]
    path = cache_path(cfg_file, wl["k"])
    if path.exists():
        return path, False
    keys, counts = count(genome.codes, wl["k"])
    text = repetitive_list(keys, counts, wl["k"], wl["distinct"])
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".part")
    tmp.write_bytes(text)
    tmp.replace(path)
    return path, True
