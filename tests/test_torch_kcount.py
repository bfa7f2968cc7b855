"""The port's k-mer counter (winnowmap_tpu_torch/kcount, KC's plain PyTorch
version on the CPU) against the JAX package's: count_block_plain against
_compiled_count_block (jax.enable_x64 on the CPU) for k = 1, 15, 19, 31,
32 in every direction, on blocks with N runs, all invalid, poly-A;
iter_code_blocks against the JAX one; count_kmers with many small blocks
against the JAX count_kmers_device and the host counter.  u64 keys and
int64 counts: every comparison is exact.

One case differs on purpose: at k = 32 a valid all-ones k-mer (poly-G
forward, poly-C reverse) is the JAX function's invalid-window mark, and it
drops it; KC counts it, as the host counter does.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from winnowmap_tpu_torch import kcount as PK
from winnowmap_tpu_torch.kcount import device as KD
from winnowmap_tpu_torch.kcount import outofcore as PO

torch.set_num_threads(1)

DIRS = ("canonical", "forward", "reverse")
# (k, codes a block): each case one compiled JAX shape
KS = {1: 4096, 15: 16384, 19: 8192, 31: 65536, 32: 32768}


def _blocks(rng, n):
    """Blocks of n codes: random with N runs (the first across the start),
    random with scattered N bases, all invalid, poly-A with N runs."""
    a = rng.integers(0, 4, n).astype(np.uint8)
    for _ in range(6):
        at = int(rng.integers(0, n - 40))
        a[at:at + int(rng.integers(1, 40))] = 255
    a[:5] = 255
    b = rng.integers(0, 4, n).astype(np.uint8)
    b[rng.random(n) < 0.02] = 255
    poly = np.zeros(n, np.uint8)
    poly[n // 3:n // 3 + 7] = 255
    return {"n-runs": a, "scattered-n": b,
            "invalid": np.full(n, 255, np.uint8), "poly-a": poly}


def _jax_block(k, n, direction, codes):
    import jax

    from winnowmap_tpu.kcount.device import _compiled_count_block

    u, c, ns = _compiled_count_block(k, n, direction)(codes)
    with jax.enable_x64():
        ns = int(ns)
        return np.asarray(u)[:ns], np.asarray(c)[:ns].astype(np.int64)


@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("k", sorted(KS))
def test_count_block_plain_matches_jax(k, direction):
    """n_seg and the first n_seg k-mers and counts equal the JAX
    function's on every block."""
    n = KS[k]
    for name, codes in _blocks(np.random.default_rng(k), n).items():
        want_k, want_c = _jax_block(k, n, direction, codes)
        got_k, got_c = KD.count_block(torch.from_numpy(codes), k, direction)
        assert np.array_equal(got_k.numpy().view(np.uint64), want_k), name
        assert np.array_equal(got_c.numpy(), want_c), name
        if name == "invalid":
            assert len(got_k) == 0
        if name == "poly-a" and direction != "reverse":
            # the all-A k-mer (code 0) leads with the most windows
            assert got_k[0] == 0 and got_c[0] == n - 7 - 2 * (k - 1)


@pytest.mark.parametrize("k", [1, 15, 32])
def test_count_block_shorter_than_k(k):
    """A block shorter than k has no window: nothing counted (the JAX
    package's count_kmers_device skips such a block before its kernel)."""
    codes = torch.zeros(k - 1, dtype=torch.uint8)
    km, ct = KD.count_block(codes, k, "canonical")
    assert len(km) == 0 and len(ct) == 0
    km, ct = KD.count_block(torch.zeros(k, dtype=torch.uint8), k, "forward")
    assert km.tolist() == [0] and ct.tolist() == [1]


@pytest.mark.parametrize("direction,base", [("forward", b"G"),
                                            ("reverse", b"C")])
def test_all_ones_kmer_at_k32(direction, base):
    """The pinned difference: 64 x G forward (64 x C reverse) at k = 32 is
    33 windows of the all-ones k-mer.  The host counter counts them; the
    JAX function returns n_seg 0, its invalid-window mark being that key;
    KC counts them as the host does."""
    seq = base * 64
    host = PK.seq_to_kmers(seq, 32, direction)
    assert len(host) == 33 and (host == np.uint64(KD.SENTINEL)).all()
    codes = PK.MERYL_CODE[np.frombuffer(seq, np.uint8)]
    want_k, _ = _jax_block(32, 64, direction, codes)
    assert len(want_k) == 0  # the JAX function drops them
    km, ct = KD.count_block(torch.from_numpy(codes), 32, direction)
    assert km.numpy().view(np.uint64).tolist() == [KD.SENTINEL]
    assert ct.tolist() == [33]
    kc = PK.count_kmers([SimpleNamespace(seq=seq)], 32, device="cpu",
                        direction=direction)
    hc = PO.count_kmers_chunked([SimpleNamespace(seq=seq)], 32,
                                direction=direction)
    assert kc.kmers.tolist() == hc.kmers.tolist() == [KD.SENTINEL]
    assert kc.counts.tolist() == hc.counts.tolist() == [33]


def _records(rng, lens):
    return [SimpleNamespace(seq=rng.choice(list(b"ACGTacgtN"), n).astype(
        np.uint8).tobytes()) for n in lens]


@pytest.mark.parametrize("k,n_block,lens", [
    # the first record ends 3 codes before a block's end: its separator
    # runs across the boundary
    (15, 64, (61, 200, 5, 64, 1, 90)),
    # a record ends exactly on a boundary; records shorter than k
    (15, 64, (64, 10, 49, 128, 3)),
    (1, 16, (16, 3, 30)),
    (32, 128, (500, 31, 32, 200))])
def test_iter_code_blocks_matches_jax(k, n_block, lens):
    from winnowmap_tpu.kcount.device import iter_code_blocks as jiter

    recs = _records(np.random.default_rng(n_block + k), lens)
    want = list(jiter(recs, k, n_block))
    got = list(KD.iter_code_blocks(recs, k, n_block))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("direction", DIRS)
def test_count_kmers_many_blocks(ref_records, monkeypatch, direction):
    """The golden genome in blocks of 4096 codes (~50 runs merged): equal
    to the JAX count_kmers_device (same block size; canonical) and to the
    host counter, and every window counted once."""
    import winnowmap_tpu.kcount.device as JD

    monkeypatch.setattr(KD, "BLOCK", 1 << 12)
    got = PK.count_kmers(ref_records, 15, device="cpu", direction=direction)
    host = PO.count_kmers_chunked(ref_records, 15, direction=direction)
    assert np.array_equal(got.kmers, host.kmers)
    assert np.array_equal(got.counts, host.counts)
    assert got.n_total == sum(len(r.seq) - 14 for r in ref_records)
    if direction == "canonical":
        monkeypatch.setattr(JD, "BLOCK", 1 << 12)
        want = JD.count_kmers_device(ref_records, 15)
        assert np.array_equal(got.kmers, want.kmers)
        assert np.array_equal(got.counts, want.counts)


def test_count_kmers_memory_budget_takes_the_host_counter(ref_records):
    """An explicit max_memory_bytes runs the host's out-of-core counter
    (spilled runs), with the block path's result."""
    got = PK.count_kmers(ref_records, 15, max_memory_bytes=1 << 20)
    want = PK.count_kmers(ref_records, 15, device="cpu")
    assert np.array_equal(got.kmers, want.kmers)
    assert np.array_equal(got.counts, want.counts)


def test_count_kmers_needs_a_card(ref_records, monkeypatch):
    """device=None is the card: without one, count_kmers raises rather
    than counting on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PK.count_kmers(ref_records[:1], 15)
    with pytest.raises(RuntimeError, match="CUDA"):
        KD.count_kmers_device(ref_records[:1], 15, "forward")


def test_count_block_refuses_what_kc_does_not_take():
    codes = torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(ValueError):
        KD.count_block(codes, 33)
    with pytest.raises(ValueError):
        KD.count_block(codes, 15, "both")
    with pytest.raises(ValueError, match="CUDA"):
        KD.count_block_launch(codes, 15)
