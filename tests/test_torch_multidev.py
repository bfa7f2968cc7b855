"""The port's multi-device drivers on the CPU: parallel/multidev's
map_batch_multidev over devices ["cpu", "cpu"] (two engines in two host
threads, the kernels' plain versions) on tests/test_multidev.py's 12 kb
genome and reads, equal to one engine and to the JAX package's engine
(WM_NO_TPU=1); the split driver map/engine.map_batch_engine_pipelined
(ways 2) on 72 short reads, equal to one engine; map_batch's routing to
every card; parallel/kcount's count_kmers_multidev over four "cpu"
devices with 4 Ki-code blocks, in three directions, equal to count_kmers
and to the JAX package's counter; and the counters two engines share
(STATS, and the launch counts' helper) exact under threads."""
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_engine import assert_same_results

torch.set_num_threads(1)


def _genome_and_reads(n_reads=4, lens=(1500, 3000), seed=5):
    """tests/test_multidev.py's 12 kb genome and its mutated reads."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 12000)
    gstr = bytes(bytearray(b"ACGT"[int(c)] for c in genome))
    reads, names = [], []
    for i in range(n_reads):
        s = int(rng.integers(0, 8000))
        L = int(rng.integers(*lens))
        sub = bytearray(gstr[s:s + L])
        for _ in range(L // 25):
            p = int(rng.integers(0, L))
            sub[p] = b"ACGT"[int(rng.integers(0, 4))]
        reads.append(bytes(sub))
        names.append(f"r{i}")
    return gstr, reads, names


def _setup(pkg, gstr):
    import importlib

    build = importlib.import_module(f"{pkg}.index.build")
    O = importlib.import_module(f"{pkg}.options")
    rec = [SimpleNamespace(name="chr1", seq=gstr, comment=None)]
    io_, mo = O.IndexOptions(), O.MapOptions()
    mo.flag |= O.MM_F_CIGAR
    mi = build.build_index(rec, io_.w, io_.k, io_.flag,
                           np.zeros(0, np.uint64))
    O.update_mid_occ(mo, mi)
    return mi, mo


def test_multidev_equals_one_engine_and_jax(monkeypatch):
    from winnowmap_tpu_torch.map.engine import STATS, map_batch_engine
    from winnowmap_tpu_torch.parallel.multidev import map_batch_multidev

    gstr, reads, names = _genome_and_reads()
    mi, mo = _setup("winnowmap_tpu_torch", gstr)
    STATS.clear()
    one = map_batch_engine(mi, mo, reads, names, torch.device("cpu"))
    jobs_one = STATS["dev_jobs"]
    STATS.clear()
    two = map_batch_multidev(mi, mo, reads, names, devices=["cpu", "cpu"])
    assert_same_results(one, two)
    assert jobs_one > 0 and STATS["dev_jobs"] == jobs_one
    assert STATS["delivered_jobs"] == STATS["dev_jobs"]
    assert STATS["eng_host_dp_calls"] == 0

    monkeypatch.setenv("WM_NO_TPU", "1")
    from winnowmap_tpu.map.engine import map_batch_engine as jax_engine

    jmi, jmo = _setup("winnowmap_tpu", gstr)
    assert_same_results(jax_engine(jmi, jmo, reads, names), two)


def test_pipelined_split_equals_one_engine():
    """ways=2 over 72 reads of 300-700 bases: two drivers (one for every
    64 reads at most), results in input order."""
    from winnowmap_tpu_torch.map.engine import (STATS, map_batch_engine,
                                                map_batch_engine_pipelined)

    gstr, reads, names = _genome_and_reads(72, (300, 700), seed=11)
    mi, mo = _setup("winnowmap_tpu_torch", gstr)
    STATS.clear()
    one = map_batch_engine(mi, mo, reads, names, torch.device("cpu"))
    jobs_one = STATS["dev_jobs"]
    STATS.clear()
    split = map_batch_engine_pipelined(mi, mo, reads, names, device="cpu",
                                       ways=2)
    assert_same_results(one, split)
    assert jobs_one > 0 and STATS["dev_jobs"] == jobs_one
    assert STATS["delivered_jobs"] == jobs_one


def test_pipelined_split_clamps_its_drivers(monkeypatch):
    """The split driver is map_batch_multidev over `ways` copies of its
    device, clamped to one driver for every 64 reads."""
    from winnowmap_tpu_torch.map.engine import map_batch_engine_pipelined
    from winnowmap_tpu_torch.parallel import multidev

    routed = []
    monkeypatch.setattr(
        multidev, "map_batch_multidev",
        lambda mi, opt, seqs, qnames, devices, chain_min: routed.append(
            (len(seqs), [str(d) for d in devices], chain_min)) or [])
    for n, ways in ((72, 8), (64, 2), (200, 3), (0, 2)):
        map_batch_engine_pipelined(None, None, [b"A"] * n, ["r"] * n,
                                   device="cpu", ways=ways)
    assert routed == [(72, ["cpu"] * 2, None), (64, ["cpu"], None),
                      (200, ["cpu"] * 3, None), (0, ["cpu"], None)]


def test_map_batch_routes_to_every_card(monkeypatch):
    """device=None with several cards: map_batch hands an engine batch to
    map_batch_multidev over every card; an explicit device pins it."""
    from winnowmap_tpu_torch.map import batch
    from winnowmap_tpu_torch.parallel import multidev

    gstr, reads, names = _genome_and_reads(2)
    mi, mo = _setup("winnowmap_tpu_torch", gstr)
    routed = []
    monkeypatch.setattr(multidev, "map_batch_multidev",
                        lambda *a, **kw: routed.append(kw) or ["multi"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert batch.map_batch(mi, mo, reads, names) == ["multi"]
    assert routed == [{"chain_min": None}]
    assert len(batch.map_batch(mi, mo, reads, names, device="cpu")) == 2
    assert len(routed) == 1
    with pytest.raises(RuntimeError, match="no card|CUDA"):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        multidev.visible_cards()


@pytest.mark.parametrize("direction", ["canonical", "forward", "reverse"])
def test_count_kmers_multidev(monkeypatch, direction):
    import winnowmap_tpu_torch.kcount.device as KD
    from winnowmap_tpu.kcount import count_kmers as jax_count
    from winnowmap_tpu_torch.kcount import count_kmers
    from winnowmap_tpu_torch.parallel.kcount import count_kmers_multidev

    monkeypatch.setattr(KD, "BLOCK", 1 << 12)
    rng = np.random.default_rng(9)
    recs = []
    for i in range(5):
        g = rng.integers(0, 4, int(rng.integers(3000, 9000)))
        s = bytes(bytearray(b"ACGT"[int(c)] for c in g))
        recs.append(SimpleNamespace(name=f"c{i}", seq=s, comment=None))
    blocks = []
    real = KD.count_block
    monkeypatch.setattr(KD, "count_block",
                        lambda c, *a: blocks.append(c.device) or real(c, *a))
    m = count_kmers_multidev(recs, 15, direction=direction,
                             devices=["cpu"] * 4)
    assert len(blocks) > 4  # every slot took blocks
    h = count_kmers(recs, 15, direction=direction, device="cpu")
    j = jax_count(recs, 15, direction=direction)
    for ref in (h, j):
        assert np.array_equal(ref.kmers, m.kmers), direction
        assert np.array_equal(ref.counts, m.counts), direction


def test_native_library_loads_once_under_threads(monkeypatch):
    """native.lib() from several engine threads at once, with nothing
    loaded yet: one build (a build's temporary file is per process), one
    load, the same library for every thread."""
    import time

    from winnowmap_tpu_torch import native

    real_build = native._build
    inside, entries = [0], []

    def slow_build():
        inside[0] += 1
        entries.append(inside[0])
        time.sleep(0.2)  # any second thread would enter meanwhile
        try:
            return real_build()
        finally:
            inside[0] -= 1

    real_build()  # build outside the timed threads
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build", slow_build)
    got = [None] * 4
    ts = [threading.Thread(target=lambda i=i: got.__setitem__(i, native.lib()))
          for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert entries == [1]
    assert got[0] is not None and all(g is got[0] for g in got)


def test_counters_exact_under_threads():
    """device.count, which every LAUNCHES and STATS increment goes
    through: more threads than cores bumping one counter, with the
    interpreter switching threads every microsecond, lose nothing."""
    import os
    import sys
    from collections import defaultdict

    from winnowmap_tpu_torch.device import count

    c = defaultdict(float)
    n_threads = 2 * (os.cpu_count() or 4)

    def bump():
        for _ in range(5000):
            count(c, "n")
            count(c, "s", 0.5)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert c["n"] == 5000 * n_threads and c["s"] == 2500.0 * n_threads
