"""The -W list: the benchmark's NumPy count equals a brute-force count and
meryl's distinct= threshold, and its text loads into the program's list."""
from collections import Counter

import numpy as np
import pytest

from wmbench import kmers
from wmbench.genome import BASES


def _brute(chroms, k):
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    cnt = Counter()
    for c in chroms:
        s = BASES[c].tobytes()
        for i in range(len(s) - k + 1):
            f = s[i:i + k]
            r = f.translate(comp)[::-1]
            cnt[min(f, r)] += 1
    return cnt


@pytest.fixture(scope="module")
def chroms():
    rng = np.random.default_rng(4)
    rep = rng.integers(0, 4, 40).astype(np.uint8)
    out = []
    for n in (3000, 1700):
        c = rng.integers(0, 4, n).astype(np.uint8)
        for at in rng.integers(0, n - 40, 12):  # a repeat, either strand
            c[at:at + 40] = rep if rng.random() < 0.5 else 3 - rep[::-1]
        out.append(c)
    return out


@pytest.mark.parametrize("k", [5, 11, 15, 16])
def test_count_equals_a_dictionary_count(chroms, k):
    keys, counts = kmers.count(chroms, k)
    text = kmers.kmer_text(keys, counts, k).decode().splitlines()
    got = {ln.split("\t")[0]: int(ln.split("\t")[1]) for ln in text}
    want = {km.decode(): n for km, n in _brute(chroms, k).items()}
    assert got == want
    assert np.all(np.diff(keys.astype(np.int64)) > 0)


@pytest.mark.parametrize("frac", [0.5, 0.9, 0.9998, 1.0])
def test_threshold_is_merys_distinct(chroms, frac):
    from winnowmap_tpu_torch.kcount import KmerCounts
    keys, counts = kmers.count(chroms, 15)
    kc = KmerCounts(15, keys.astype(np.uint64), counts.astype(np.int64))
    assert kmers.threshold_distinct(counts, frac) == \
        kc.threshold_distinct(frac)


def test_list_loads_into_the_programs_weight_set(chroms, tmp_path):
    from winnowmap_tpu_torch.index.build import load_weight_set
    keys, counts = kmers.count(chroms, 15)
    text = kmers.repetitive_list(keys, counts, 15, 0.9)
    thr = kmers.threshold_distinct(counts, 0.9)
    p = tmp_path / "rep.txt"
    p.write_bytes(text)
    wset = load_weight_set(str(p), 15)
    assert np.array_equal(wset, np.sort(keys[counts > thr]).astype(
        np.uint64))
    assert len(wset) > 0


def test_cache_key_follows_the_configuration(tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text('{"x": 1}')
    b.write_text('{"x": 2}')
    pa, pb = kmers.cache_path(a, 15), kmers.cache_path(b, 15)
    assert pa != pb and pa.parent.parent == kmers.CACHE
    assert kmers.cache_path(a, 15) == pa
