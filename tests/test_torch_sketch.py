"""The port's device sketch (winnowmap_tpu_torch/sketch/device.py, the
plain PyTorch version of S1 on the CPU) against the JAX package's
sketch_device and _compiled_transform (jax.enable_x64 on the CPU) and
against the native oracle native.sketch: HPC, ambiguous bases, symmetric
k-mers, weighted sets and the bloom membership mode; the golden
minimizer dump; and the index build's device gate at 1 Mbp.  u64
arithmetic: every comparison is exact."""
from pathlib import Path

import numpy as np
import pytest
import torch

import winnowmap_tpu_torch.native as native
from winnowmap_tpu_torch.sketch import device as SD

torch.set_num_threads(1)

GOLD = Path(__file__).resolve().parent / "data" / "golden"


def _random_seq(rng, n):
    return rng.choice(list(b"ACGTacgtN"), n,
                      p=[.22, .22, .22, .22, .02, .02, .02, .02, .04]
                      ).astype(np.uint8).tobytes()


def _wset(seq, k):
    """Every 37th valid k-mer of seq, as tests/test_sketch.py builds it."""
    ws = [native.encode_kmer(seq[o:o + k])
          for o in range(0, max(1, len(seq) - k), 37)
          if len(seq[o:o + k]) == k and b"N" not in seq[o:o + k]
          and b"n" not in seq[o:o + k]]
    return np.unique(np.array(ws, np.uint64)) if ws else \
        np.zeros(0, np.uint64)


def test_sketch_parity():
    """tests/test_sketch.py::test_device_sketch_parity's 16 sequences
    (HPC on every other), k = 15, w = 50: the port == JAX sketch_device ==
    native.sketch."""
    from winnowmap_tpu.sketch.device import sketch_device as jsketch

    rng = np.random.default_rng(5)
    for trial in range(16):
        seq = _random_seq(rng, int(rng.integers(50, 2500)))
        hpc = trial % 2 == 1
        wset = _wset(seq, 15)
        hx, hy = native.sketch(seq, 50, 15, 3, hpc, wset)
        jx, jy = jsketch(seq, 50, 15, 3, hpc, wset)
        dx, dy = SD.sketch_device(seq, 50, 15, 3, hpc, wset, device="cpu")
        assert np.array_equal(hx, dx) and np.array_equal(hy, dy), trial
        assert np.array_equal(jx, dx) and np.array_equal(jy, dy), trial


@pytest.mark.parametrize("k", [1, 15, 19, 28])
def test_transform_matches_jax(k):
    """transform_plain == the JAX package's _compiled_transform, every
    output, on codes with ambiguous bases and a palindromic run."""
    import jax

    from winnowmap_tpu.sketch.device import _compiled_transform

    rng = np.random.default_rng(k)
    codes = rng.integers(0, 5, 3000).astype(np.uint8)
    codes[100:140] = np.tile([0, 3], 20)  # symmetric k-mers (ATAT...)
    with jax.enable_x64():
        want = [np.asarray(a) for a in _compiled_transform(k, False)(codes)]
    got = [t.numpy() for t in SD.transform(torch.from_numpy(codes), k)]
    names = ("key", "h", "z", "sym", "canon")
    for name, w, g in zip(names, want, got):
        w = w.astype(np.uint8) if w.dtype == bool else w
        g = g.view(np.uint64) if g.dtype == np.int64 else g
        assert np.array_equal(w.astype(g.dtype), g), name
    if k % 2 == 0:  # an even (AT)* k-mer is its own reverse complement
        assert got[3][100 + k - 1:140].all()


def test_sketch_bloom_mode(tmp_path):
    """--bloom-filter membership: the port's bloom table from a k-mer list
    == native.sketch with the same table == JAX sketch_device."""
    from winnowmap_tpu.index.build import load_weight_bloom as jbloom
    from winnowmap_tpu.sketch.device import sketch_device as jsketch
    from winnowmap_tpu_torch.index.build import load_weight_bloom

    rng = np.random.default_rng(11)
    seq = _random_seq(rng, 4000)
    kmers = [seq[o:o + 15].upper() for o in range(0, 3900, 29)
             if b"N" not in seq[o:o + 15].upper()]
    rep = tmp_path / "rep.txt"
    rep.write_text("".join(f"{km.decode()}\t9\n" for km in kmers))
    bloom = load_weight_bloom(str(rep), 15)
    jb = jbloom(str(rep), 15)
    assert all(np.array_equal(a, b) for a, b in zip(bloom, jb))
    empty = np.zeros(0, np.uint64)
    for hpc in (False, True):
        hx, hy = native.sketch(seq, 25, 15, 0, hpc, empty, bloom=bloom)
        jx, jy = jsketch(seq, 25, 15, 0, hpc, empty, bloom=jb)
        dx, dy = SD.sketch_device(seq, 25, 15, 0, hpc, empty, bloom,
                                  device="cpu")
        assert np.array_equal(hx, dx) and np.array_equal(hy, dy), hpc
        assert np.array_equal(jx, dx) and np.array_equal(jy, dy), hpc


def test_sketch_matches_golden_minimizers():
    """The golden reference through the port's device sketch == the
    reference mapper's own minimizer dump (golden_ref_minimizers.txt)."""
    from winnowmap_tpu_torch.io.fastx import read_all

    words = (GOLD / "t_rep_k15.txt").read_text().split()
    wset = np.unique(np.array(
        [native.encode_kmer(w.encode()) for w in words[::2]], np.uint64))
    want = set()
    for line in (GOLD / "golden_ref_minimizers.txt").read_text().splitlines():
        rid, pos, key = line.split()
        want.add((int(rid), int(pos), int(key)))
    got = set()
    for rid, rec in enumerate(read_all(str(GOLD / "t_ref.fa"))):
        x, y = SD.sketch_device(rec.seq, 50, 15, rid, False, wset,
                                device="cpu")
        for xi, yi in zip(x.tolist(), y.tolist()):
            got.add((yi >> 32, (yi & 0xFFFFFFFF) >> 1, xi >> 8))
    assert got == want


def _genome(total):
    from winnowmap_tpu_torch.io.fastx import SeqRecord

    rng = np.random.default_rng(20261016)
    g = rng.choice(list(b"ACGT"), total).astype(np.uint8).tobytes()
    return [SeqRecord("c1", g[:600_000], None, None),
            SeqRecord("c2", g[600_000:], None, None)]


def test_build_index_device_gate(monkeypatch):
    """A 1 Mbp genome (two sequences) sketches through the device transform
    (its plain version on device="cpu") and gives the native build's index
    arrays; below the gate the device is not used."""
    from winnowmap_tpu_torch.index import build

    recs = _genome(1_000_000)
    wset = _wset(recs[0].seq[:200_000], 15)
    calls = []
    transform = SD.transform

    def counted(codes, k):
        calls.append(len(codes))
        return transform(codes, k)

    monkeypatch.setattr(SD, "transform", counted)
    dev = build.build_index(recs, 10, 15, 0, wset, device="cpu")
    assert sum(calls) == 1_000_000
    calls.clear()
    host = build.build_index(recs, 10, 15, 0, wset, sketch_min_bp=1_000_001)
    assert not calls
    for f in ("keys", "start", "pos", "codes"):
        a, b = getattr(host, f), getattr(dev, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_build_index_default_device_is_cuda():
    """device=None means the card: at the gate, without one, the build
    raises instead of sketching on the CPU."""
    from winnowmap_tpu_torch.index.build import build_index

    if torch.cuda.is_available():
        pytest.skip("a card is present; the CUDA path is tested in "
                    "test_torch_gpu.py")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index(_genome(1_000_000), 10, 15)
