"""The port's chain forward pass (winnowmap_tpu_torch/chain/device.py, the
plain PyTorch version of C1 on the CPU) against the JAX package's
_compiled_chain_fwd (jax.enable_x64 on the CPU, as tests/test_chain_device.py
runs it) and against the scalar oracle native.chain_dp; and the chain
exchange of the port's engine and the generator path's chain routing,
byte-equal to the host chains and to the JAX package's engine.  Integer
DP with f64 gap costs rounded as C doubles: every comparison is exact.

The anchor sets mirror tests/test_chain_device.py (random colinear
clusters, repeat-rich clusters whose windows grow by Winnowmap's
min_dist_x rule, anchors near reference position 0, stage-2 parameters),
plus one window wider than the JAX package's cap of 8192, which the port
takes on the device and the JAX package sends to native.chain_dp.
"""
import math

import numpy as np
import pytest
import torch

import winnowmap_tpu_torch.native as native
from winnowmap_tpu_torch.chain import device as CD
from winnowmap_tpu_torch.chain.check import anchor_set as _make_anchors

torch.set_num_threads(1)

P = dict(max_dist_x=5000, min_dist_x=1000, max_dist_y=5000, bw=500,
         max_skip=25, max_iter=5000, min_cnt=3, min_sc=40, gap_scale=1.0,
         is_cdna=0)


def _low_coordinate_jobs(rng):
    """tests/test_chain_device.py::test_chain_device_low_coordinates: anchors
    within max_dist_x of position 0 on rid 0."""
    jobs = []
    for _ in range(4):
        m = 60
        x = np.sort(rng.integers(0, 3000, m)).astype(np.uint64)
        y = (x - np.uint64(x.min())) + rng.integers(0, 9, m).astype(np.uint64)
        span = np.full(m, 15, np.uint64)
        ay = (span << np.uint64(32)) | (y & np.uint64(0xFFFFFFFF))
        o = np.argsort(x, kind="stable")
        jobs.append((x[o], ay[o]))
    return jobs


def _port_fwd(jobs, p):
    """The port's (f, pre, v) per job, the plain version on the CPU."""
    cj = CD.chain_jobs(jobs, p["max_dist_x"], p["min_dist_x"],
                       p["max_iter"], "cpu")
    out = CD.chain_fwd(cj, p["max_dist_x"], p["max_dist_y"], p["bw"],
                       p["max_skip"], p["is_cdna"],
                       float(np.float32(p["gap_scale"]))).numpy()
    off = cj.off.tolist()
    return [out[:, off[b]:off[b + 1]] for b in range(len(jobs))]


def _jax_fwd(jobs, p):
    """The JAX package's _compiled_chain_fwd on all jobs in one call (one
    compile), packed as its chain_dp_device_batch packs a group."""
    import jax

    from winnowmap_tpu.chain.device import (_compiled_chain_fwd,
                                            _window_starts, quantize_win)

    sts = [_window_starts(ax, p["max_dist_x"], p["min_dist_x"],
                          p["max_iter"]) for ax, _ in jobs]
    for (ax, _), st in zip(jobs, sts):
        assert np.array_equal(st, CD._window_starts(
            ax, p["max_dist_x"], p["min_dist_x"], p["max_iter"]))
    W = quantize_win(max(1, max(int((np.arange(len(st)) - st).max())
                                for st in sts)))
    assert W > 0
    N = 1 << max(7, math.ceil(math.log2(max(len(ax) for ax, _ in jobs))))
    TB = len(jobs)
    xlo = np.zeros((TB, W + N), np.int32)
    yqa = np.zeros((TB, W + N), np.int32)
    spa = np.zeros((TB, W + N), np.int32)
    sta = np.zeros((TB, N), np.int32)
    n_a = np.zeros((TB, 1), np.int32)
    avq = np.zeros((TB, 1), np.float64)
    lo32 = np.uint64(0xFFFFFFFF)
    for b, ((ax, ay), st) in enumerate(zip(jobs, sts)):
        n = len(ax)
        xlo[b, W:W + n] = (ax & lo32).astype(np.uint32).view(np.int32)
        yqa[b, W:W + n] = (ay & lo32).astype(np.uint32).view(np.int32)
        spa[b, W:W + n] = ((ay >> np.uint64(32))
                           & np.uint64(0xFF)).astype(np.int32)
        sta[b, :n] = st
        n_a[b, 0] = n
        s32 = np.float32(spa[b, W:W + n].sum(dtype=np.uint64))
        avq[b, 0] = np.float64(s32 / np.float32(n))
    with jax.enable_x64():
        fwd = _compiled_chain_fwd(TB, N, W, p["max_dist_x"],
                                  p["max_dist_y"], p["bw"], p["max_skip"],
                                  bool(p["is_cdna"]), float(p["gap_scale"]))
        f, pre, v = (np.asarray(a) for a in fwd(xlo, yqa, spa, sta, n_a,
                                                  avq))
    return [np.stack([f[b, :len(ax)], pre[b, :len(ax)], v[b, :len(ax)]])
            for b, (ax, _) in enumerate(jobs)]


def _assert_native(jobs, p, results):
    for t, (ax, ay) in enumerate(jobs):
        want = native.chain_dp(ax, ay, n_segs=1, **p)
        for a, b in zip(want, results[t]):
            assert np.array_equal(a, b), f"job {t}, {len(ax)} anchors"


def _assert_fwd_equal(jobs, p):
    """The port's forward pass equals the JAX package's, and chained to the
    end (chain_dp_device_batch) equals native.chain_dp."""
    for t, (a, b) in enumerate(zip(_port_fwd(jobs, p), _jax_fwd(jobs, p))):
        assert np.array_equal(a, b), f"f/pre/v differ on job {t}"
    res = CD.chain_dp_device_batch(
        jobs, p["max_dist_x"], p["min_dist_x"], p["max_dist_y"], p["bw"],
        p["max_skip"], p["max_iter"], p["min_cnt"], p["min_sc"],
        p["gap_scale"], p["is_cdna"], "cpu")
    _assert_native(jobs, p, res)


def test_chain_parity_quick():
    """test_chain_device_parity_quick's 16 sets against native.chain_dp, and
    eight of its shape (one JAX compile) against _compiled_chain_fwd."""
    rng = np.random.default_rng(3)
    jobs = [_make_anchors(rng, int(rng.integers(50, 3000)),
                          repeat=(t % 3 == 0)) for t in range(16)]
    res = CD.chain_dp_device_batch(
        jobs, P["max_dist_x"], P["min_dist_x"], P["max_dist_y"], P["bw"],
        P["max_skip"], P["max_iter"], P["min_cnt"], P["min_sc"],
        P["gap_scale"], P["is_cdna"], "cpu")
    _assert_native(jobs, P, res)
    rng = np.random.default_rng(4)
    _assert_fwd_equal([_make_anchors(rng, int(rng.integers(50, 1200)),
                                     repeat=(t % 3 == 0))
                       for t in range(8)], P)


def test_chain_low_coordinates():
    _assert_fwd_equal(_low_coordinate_jobs(np.random.default_rng(21)), P)


P2 = dict(P, bw=2000, max_dist_x=16000, max_dist_y=16000)


def test_chain_stage2_params():
    """Stage-2 parameters (wide band, bigger gaps)."""
    rng = np.random.default_rng(9)
    _assert_fwd_equal([_make_anchors(rng, 900, repeat=True)
                       for _ in range(4)], P2)


def test_chain_max_skip_break():
    """At max_skip 1 and 0 the oracle's break (its t[] marks and its skip
    counter floored at 0) stops walks short of better predecessors, and
    the chains differ from an unbroken walk's: the port == the JAX package
    (max_skip 1) == native.chain_dp (both)."""
    rng = np.random.default_rng(31)
    jobs = [_make_anchors(rng, int(rng.integers(100, 1200)),
                          repeat=(t % 3 == 0)) for t in range(8)]
    for max_skip in (1, 0):
        p = dict(P, max_skip=max_skip, gap_scale=0.8)
        unbroken = dict(p, max_skip=1 << 30)
        assert any(not all(np.array_equal(a, b) for a, b in zip(
            native.chain_dp(ax, ay, n_segs=1, **p),
            native.chain_dp(ax, ay, n_segs=1, **unbroken)))
            for ax, ay in jobs)
        if max_skip:
            _assert_fwd_equal(jobs, p)
        else:
            _assert_native(jobs, p, CD.chain_dp_device_batch(
                jobs, p["max_dist_x"], p["min_dist_x"], p["max_dist_y"],
                p["bw"], p["max_skip"], p["max_iter"], p["min_cnt"],
                p["min_sc"], p["gap_scale"], p["is_cdna"], "cpu"))


def test_chain_cdna_gap_cost():
    """cDNA's gap cost (min(linear, log) where dr > dq), which no JAX test
    takes, against native.chain_dp."""
    rng = np.random.default_rng(10)
    jobs = [_make_anchors(rng, int(rng.integers(200, 1500)),
                          repeat=(t % 2 == 0)) for t in range(6)]
    p = dict(P2, is_cdna=1)
    _assert_native(jobs, p, CD.chain_dp_device_batch(
        jobs, p["max_dist_x"], p["min_dist_x"], p["max_dist_y"], p["bw"],
        p["max_skip"], p["max_iter"], p["min_cnt"], p["min_sc"],
        p["gap_scale"], p["is_cdna"], "cpu"))


def test_chain_window_wider_than_jax_cap():
    """A repeat cluster of 8,400 anchors within min_dist_x: windows up to
    8,399 anchors, above the JAX package's cap of 8192 (its
    chain_dp_device_batch chains such a set with native.chain_dp); the
    port's forward pass takes it whole, gap scale 0.8 through its float
    cast."""
    from winnowmap_tpu.chain.device import chain_dp_device_batch as jbatch

    rng = np.random.default_rng(8)
    job = _make_anchors(rng, 8400, repeat=True, n_clusters=1)
    p = dict(P, gap_scale=0.8)
    st = CD._window_starts(job[0], p["max_dist_x"], p["min_dist_x"],
                           p["max_iter"])
    assert (np.arange(len(st)) - st).max() > 8192
    got = CD.chain_dp_device_batch(
        [job], p["max_dist_x"], p["min_dist_x"], p["max_dist_y"], p["bw"],
        p["max_skip"], p["max_iter"], p["min_cnt"], p["min_sc"],
        p["gap_scale"], p["is_cdna"], "cpu")
    _assert_native([job], p, got)
    want = jbatch([job], p["max_dist_x"], p["min_dist_x"], p["max_dist_y"],
                  p["bw"], p["max_skip"], p["max_iter"], p["min_cnt"],
                  p["min_sc"], p["gap_scale"], p["is_cdna"])[0]
    for a, b in zip(want, got[0]):
        assert np.array_equal(a, b)


def test_chain_dp_auto_gate(monkeypatch):
    """chain_dp_auto sends one-segment sets of at least chain_min anchors
    to the device path and the others (and chain_min 0) to the host."""
    routed = []
    batch = CD.chain_dp_device_batch

    def spy(jobs, *a):
        routed.append(len(jobs[0][0]))
        return batch(jobs, *a)

    monkeypatch.setattr(CD, "chain_dp_device_batch", spy)
    job = _make_anchors(np.random.default_rng(5), 400)
    kw = dict(P, device="cpu")
    for chain_min, n_segs, sent in ((400, 1, True), (401, 1, False),
                                    (0, 1, False), (1, 2, False)):
        got = CD.chain_dp_auto(*job, n_segs=n_segs, chain_min=chain_min,
                               **kw)
        want = native.chain_dp(*job, n_segs=n_segs, **P)
        assert all(np.array_equal(a, b) for a, b in zip(want, got))
        assert bool(routed) == sent
        routed.clear()
    assert CD.chain_gate(None, torch.device("cpu")) == 0
    assert CD.chain_gate(None, torch.device("cuda")) == 50_000
    assert CD.chain_gate(7, torch.device("cuda")) == 7
    assert CD.chain_gate(0, torch.device("cuda")) == 0


def _corpus():
    """tests/test_chain_exchange.py's corpus: a 15 kb genome and four
    reads of 1.2-2.5 kb with 4% substitutions."""
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 15000)
    gstr = bytes(bytearray(b"ACGT"[int(c)] for c in genome))
    reads, names = [], []
    for i in range(4):
        s = int(rng.integers(0, 10000))
        L = int(rng.integers(1200, 2500))
        sub = bytearray(gstr[s:s + L])
        for _ in range(L // 25):
            sub[int(rng.integers(0, L))] = b"ACGT"[int(rng.integers(0, 4))]
        reads.append(bytes(sub))
        names.append(f"r{i}")
    return gstr, reads, names


def _port_index(gstr):
    from winnowmap_tpu_torch.index.build import build_index
    from winnowmap_tpu_torch.io.fastx import SeqRecord
    from winnowmap_tpu_torch.options import (MM_F_CIGAR, IndexOptions,
                                             MapOptions, update_mid_occ)

    io_, mo = IndexOptions(), MapOptions()
    mo.flag |= MM_F_CIGAR
    mi = build_index([SeqRecord("chr1", gstr, None, None)], io_.w, io_.k,
                     io_.flag, np.zeros(0, np.uint64))
    update_mid_occ(mo, mi)
    return mi, mo


def test_engine_chain_exchange_byte_equal(monkeypatch):
    """Every chain of the port's engine through the exchange (chain_min 1,
    the plain forward pass) == every chain on the engine's scalar DP
    (chain_min 0) == the JAX package's engine on its host kernels."""
    from test_torch_engine import assert_same_results

    from winnowmap_tpu.index.build import build_index as jbuild
    from winnowmap_tpu.map.engine import map_batch_engine as jengine
    from winnowmap_tpu.options import (MM_F_CIGAR as J_CIGAR,
                                       IndexOptions as JIO,
                                       MapOptions as JMO,
                                       update_mid_occ as jmid)
    from winnowmap_tpu_torch.map.engine import STATS, map_batch_engine

    gstr, reads, names = _corpus()
    rec = [type("R", (), {"name": "chr1", "seq": gstr, "comment": None})()]
    jio, jmo = JIO(), JMO()
    jmo.flag |= J_CIGAR
    jmi = jbuild(rec, jio.w, jio.k, jio.flag, np.zeros(0, np.uint64))
    jmid(jmo, jmi)
    monkeypatch.setenv("WM_NO_TPU", "1")
    ref = jengine(jmi, jmo, reads, names)
    mi, mo = _port_index(gstr)
    cpu = torch.device("cpu")
    host = map_batch_engine(mi, mo, reads, names, cpu, chain_min=0)
    STATS.clear()
    got = map_batch_engine(mi, mo, reads, names, cpu, chain_min=1)
    assert STATS["chain_dev_jobs"] > 0
    assert STATS["chain_dev_anchors"] >= STATS["chain_dev_jobs"]
    assert_same_results(ref, host)
    assert_same_results(ref, got)


def test_generator_chain_route_byte_equal(monkeypatch):
    """The generator path with every chain through chain_dp_auto's device
    path (a gate of 1 anchor) == with every chain on native.chain_dp (the
    CPU's gate, 0)."""
    from test_torch_engine import assert_same_results

    from winnowmap_tpu_torch.map import batch

    n = []
    device_batch = CD.chain_dp_device_batch

    def counted(jobs, *a):
        n.append(len(jobs))
        return device_batch(jobs, *a)

    monkeypatch.setattr(CD, "chain_dp_device_batch", counted)
    gstr, reads, names = _corpus()
    mi, mo = _port_index(gstr)
    host = batch.map_batch_generator(mi, mo, reads, names, "cpu")
    assert not n
    got = batch.map_batch_generator(mi, mo, reads, names, "cpu",
                                    chain_min=1)
    assert n
    assert_same_results(host, got)
