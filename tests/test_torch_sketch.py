"""The port's device sketch (winnowmap_tpu_torch/sketch/device.py, the
plain PyTorch version of S1 on the CPU) against the JAX package's
sketch_device, _compiled_transform and _transform_device (jax.enable_x64
on the CPU) and against the native oracle native.sketch: HPC, ambiguous
bases, symmetric k-mers, weighted sets (hits on their first and last
entries, k-mers just outside them) and the bloom membership mode; the
golden minimizer dump; the index build's one launch over records of 0, 1,
k - 1 and k bases; and its device gate at 1 Mbp.  u64 arithmetic and the
f64 order: every comparison is exact."""
from pathlib import Path

import numpy as np
import pytest
import torch

import winnowmap_tpu_torch.native as native
from winnowmap_tpu_torch.index.build import weight_bloom
from winnowmap_tpu_torch.io.seqcode import encode
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
    got = [t.numpy() for t in SD.transform_plain(torch.from_numpy(codes), k)]
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
    """A 1 Mbp genome (two sequences) sketches through S1 (its plain
    version on device="cpu"), in one call over both sequences with 14 pad
    codes before each, and gives the native build's index arrays; below
    the gate the device is not used."""
    from winnowmap_tpu_torch.index import build

    recs = _genome(1_000_000)
    wset = _wset(recs[0].seq[:200_000], 15)
    calls = []
    sketch = SD.sketch

    def counted(codes, k, wt, out=None):
        calls.append(len(codes))
        return sketch(codes, k, wt, out)

    monkeypatch.setattr(SD, "sketch", counted)
    dev = build.build_index(recs, 10, 15, 0, wset, device="cpu")
    assert calls == [1_000_000 + 2 * 14]
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


def _codes_with_edges(rng, n, k):
    """n codes 0..4 with N runs, a palindromic (AT)* run and a
    homopolymer run (HPC compacts it)."""
    codes = rng.integers(0, 4, n).astype(np.uint8)
    for at in rng.integers(0, n - 40, 6):
        codes[at:at + int(rng.integers(1, 30))] = 4
    codes[100:140] = np.tile([0, 3], 20)
    codes[300:360] = 2
    return codes


def _edge_set(canon, rng):
    """A sorted set over the canonical k-mers in `canon`: every 5th of them
    from the second to the second-to-last (so the smallest and the largest
    k-mer lie just outside it and its first and last entries are hit), and
    as many values that no window holds."""
    u = np.unique(canon)
    inner = u[1:-1]
    picks = np.concatenate([inner[::5], inner[-1:],
                            rng.integers(int(inner[0]) + 1, int(inner[-1]),
                                         len(inner) // 5 + 1,
                                         dtype=np.uint64)])
    ws = np.unique(picks.astype(np.uint64))
    assert ws[0] == inner[0] and ws[-1] == inner[-1]
    return ws


@pytest.mark.parametrize("mode", ["none", "set", "bloom"])
@pytest.mark.parametrize("hpc", [False, True], ids=["plain", "hpc"])
@pytest.mark.parametrize("k", [15, 19, 28])
def test_s1_plain_matches_jax(k, hpc, mode):
    """sketch_plain (the new S1's function) == the JAX package's
    _transform_device (transform and membership) and its sketch_device's
    f64 order (winnowmap_tpu/sketch/device.py:157-164), on the same
    numpy-seeded codes: key, the order's bits, z | sym << 1, and which
    k-mers are down-weighted."""
    import jax

    from winnowmap_tpu.sketch.device import _transform_device

    rng = np.random.default_rng(1000 * k + 10 * hpc + len(mode))
    codes = _codes_with_edges(rng, 4000, k)
    if hpc:
        codes = SD.compact_hpc(codes)[0]
    canon = SD.transform_plain(torch.from_numpy(codes), k)[4].numpy().view(
        np.uint64)
    ws, bloom = np.zeros(0, np.uint64), None
    if mode != "none":
        ws = _edge_set(canon, rng)
    if mode == "bloom":
        bloom, ws = weight_bloom(ws), np.zeros(0, np.uint64)
    with jax.enable_x64():
        key, h, z, sym, flagged = _transform_device(codes, ws, k, hpc,
                                                    bloom=bloom)
    x = h.astype(np.float64) / np.float64(np.uint64(0xFFFFFFFFFFFFFFFF))
    ordv = -x
    if flagged.any():
        xf = x[flagged]
        p2 = xf * xf
        p4 = p2 * p2
        ordv[flagged] = -(p4 * p4)
    wt = SD.weights_on(ws, bloom, "cpu")
    gk, go, gf = (t.numpy() for t in SD.sketch_plain(torch.from_numpy(codes),
                                                     k, wt))
    got_flagged = SD.flagged_plain(torch.from_numpy(canon.view(np.int64)),
                                   wt).numpy()
    assert np.array_equal(got_flagged, flagged)
    if mode == "set":
        assert flagged[canon == ws[0]].any() and flagged[canon == ws[-1]].any()
        assert not flagged[(canon < ws[0]) | (canon > ws[-1])].any()
        assert (canon < ws[0]).any() and (canon > ws[-1]).any()
    if mode != "none":
        assert 0 < flagged.sum() < len(flagged)
    assert np.array_equal(gk.view(np.uint64), key)
    assert np.array_equal(go.view(np.uint64), ordv.view(np.uint64))
    assert np.array_equal(gf, np.asarray(z).astype(np.uint8)
                          | (np.asarray(sym).astype(np.uint8) << 1))


@pytest.mark.parametrize("hpc", [False, True], ids=["plain", "hpc"])
@pytest.mark.parametrize("k,w", [(19, 19), (28, 10)])
def test_sketch_device_k_matches_native_and_jax(k, w, hpc):
    """sketch_device(device="cpu") == native.sketch == the JAX
    sketch_device at k = 19 and 28, with a weighted set of every 37th
    k-mer."""
    from winnowmap_tpu.sketch.device import sketch_device as jsketch

    rng = np.random.default_rng(k + hpc)
    for trial in range(3):
        seq = _random_seq(rng, int(rng.integers(200, 3000)))
        wset = _wset(seq.upper(), k)
        want = native.sketch(seq, w, k, trial, hpc, wset)
        got = SD.sketch_device(seq, w, k, trial, hpc, wset, device="cpu")
        jx = jsketch(seq, w, k, trial, hpc, wset)
        assert all(np.array_equal(a, b) for a, b in zip(want, got)), trial
        assert all(np.array_equal(a, b) for a, b in zip(jx, got)), trial


@pytest.mark.parametrize("mode", ["set", "bloom"])
@pytest.mark.parametrize("hpc", [False, True], ids=["plain", "hpc"])
def test_build_index_one_launch_over_records(monkeypatch, hpc, mode):
    """Records of 0, 1, k - 1, k and a few thousand bases, with N runs at
    their edges, through build_index's one S1 call (sketch_min_bp 0, the
    plain version on the CPU) == the native build, array for array."""
    from winnowmap_tpu_torch.index import build
    from winnowmap_tpu_torch.io.fastx import SeqRecord

    k, w = 15, 10
    rng = np.random.default_rng(31 + hpc)
    lens = [0, 1, k - 1, k, 2500, 0, 1800, k + 1, 3100]
    recs = []
    for i, n in enumerate(lens):
        s = bytearray(rng.choice(list(b"ACGTacgt"), n).astype(np.uint8))
        if n > 40:  # N runs at both edges, a homopolymer run
            s[:7], s[-5:] = b"NNNNNNN", b"NNNNN"
            s[600:640] = b"A" * 40
        elif n == k:
            s[-1:] = b"N"
        recs.append(SeqRecord(f"r{i}", bytes(s), None, None))
    wset = _wset(b"".join(r.seq for r in recs).upper(), k)
    bloom = None
    if mode == "bloom":
        bloom, wset = weight_bloom(wset), np.zeros(0, np.uint64)
    calls = []
    sketch = SD.sketch

    def counted(codes, k_, wt, out=None):
        calls.append(len(codes))
        return sketch(codes, k_, wt, out)

    monkeypatch.setattr(SD, "sketch", counted)
    dev = build.build_index(recs, w, k, 0, wset, hpc, bloom, device="cpu",
                            sketch_min_bp=0)
    assert len(calls) == 1
    host = build.build_index(recs, w, k, 0, wset, hpc, bloom,
                             sketch_min_bp=None)
    assert len(host.pos) > 100
    for f in ("keys", "start", "pos", "codes"):
        a, b = getattr(host, f), getattr(dev, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("seed", [0, 1, 5, 6])
def test_sketch_device_symmetric_around_ambiguous_base(seed):
    """A reverse-complement palindrome of 7 + N + 7 bases (k = 15): the
    positional k-mer (N as 0) is symmetric at its end, the oracle's
    (which skips the N and keeps the base before it) is not.  The port
    decides the symmetric test on the oracle's k-mer, so it equals
    native.sketch at w = 3, 5, 10, HPC off and on (the positional test
    made l differ and shifted minimizers on these inputs)."""
    rng = np.random.default_rng(seed)
    s = bytearray(rng.choice(list(b"ACGT"), 400).astype(np.uint8))
    left = bytes(rng.choice(list(b"ACGT"), 7).astype(np.uint8))
    mid = left + b"N" + left.translate(bytes.maketrans(b"ACGT",
                                                       b"TGCA"))[::-1]
    s[200:215] = mid
    seq = bytes(s)
    sym = SD.transform_plain(torch.from_numpy(encode(seq)), 15)[3]
    assert sym[214] == 1
    none = np.zeros(0, np.uint64)
    for hpc in (False, True):
        for w in (3, 5, 10):
            want = native.sketch(seq, w, 15, 0, hpc, none)
            got = SD.sketch_device(seq, w, 15, 0, hpc, none, device="cpu")
            assert all(np.array_equal(a, b) for a, b in zip(want, got)), \
                (hpc, w)


def test_build_index_launch_groups(monkeypatch):
    """A genome above SKETCH_MAX_CODES goes to S1 in several launches of
    whole records (a record longer than the cap alone): the index still
    equals the native build."""
    from winnowmap_tpu_torch.index import build
    from winnowmap_tpu_torch.io.fastx import SeqRecord

    rng = np.random.default_rng(41)
    recs = [SeqRecord(f"r{i}", _random_seq(rng, n), None, None)
            for i, n in enumerate([900, 1200, 3000, 400, 700])]
    monkeypatch.setattr(build, "SKETCH_MAX_CODES", 2000)
    assert [len(g) for g in build._launch_groups(
        build.build_index(recs, 10, 15, sketch_min_bp=None).seqs)] == \
        [1, 1, 1, 2]
    calls = []
    sketch = SD.sketch

    def counted(codes, k, wt, out=None):
        calls.append(len(codes))
        return sketch(codes, k, wt, out)

    monkeypatch.setattr(SD, "sketch", counted)
    dev = build.build_index(recs, 10, 15, device="cpu", sketch_min_bp=0)
    assert calls == [914, 1214, 3014, 1128]
    host = build.build_index(recs, 10, 15, sketch_min_bp=None)
    for f in ("keys", "start", "pos"):
        assert np.array_equal(getattr(host, f), getattr(dev, f)), f


def test_build_index_hpc_golden_reference():
    """t_ref.fa with HPC (-H), map-pb's k = 15 and w = 10 and the golden
    down-weight list: the index through S1 (plain, sketch_min_bp 0) == the
    native build."""
    from winnowmap_tpu_torch.index import build
    from winnowmap_tpu_torch.io.fastx import read_all

    recs = read_all(str(GOLD / "t_ref.fa"))
    wset = build.load_weight_set(str(GOLD / "t_rep_k15.txt"), 15)
    dev = build.build_index(recs, 10, 15, 1, wset, True, device="cpu",
                            sketch_min_bp=0)
    host = build.build_index(recs, 10, 15, 1, wset, True, sketch_min_bp=None)
    for f in ("keys", "start", "pos"):
        assert np.array_equal(getattr(host, f), getattr(dev, f)), f
