"""The port's parallel/ package against the JAX package's on the same
inputs: shard_reads; map_file_sharded over two shards plus merge_parts on
the first 8 golden reads, byte-equal to the JAX package's
(WM_NO_TPU=1); global_occ_quantile locally (== cal_max_occ) and over
real gloo process groups of 2, 3 and 4 ranks, each rank holding a strided
shard of the counts (== cal_max_occ of the whole index below 2^16, and
== the JAX function with its psum given the summed histogram, tail
buckets included); and pack_results rows that either package packs and
the other unpacks into equal regions."""
import io
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_engine import reg_key

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLD = REPO / "tests" / "data" / "golden"
N_READS = 8


def assert_same_regions(ref, got):
    """Regions field for field, and rep_len: what a packed row carries
    (frag_gap stays with the read, not in its rows)."""
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert [reg_key(r) for r in a.regs] == [reg_key(r) for r in b.regs], i
        assert (a.rep_len, a.rep_len_defined) == \
            (b.rep_len, b.rep_len_defined), i


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _reads_file(tmp_path, n=N_READS):
    from winnowmap_tpu_torch.io.fastx import read_all

    path = tmp_path / "reads.fa"
    with open(path, "w") as f:
        for r in read_all(str(GOLD / "t_reads.fa"))[:n]:
            f.write(f">{r.name}\n{r.seq.decode()}\n")
    return path


def _index(pkg):
    import importlib

    build = importlib.import_module(f"{pkg}.index.build")
    fastx = importlib.import_module(f"{pkg}.io.fastx")
    O = importlib.import_module(f"{pkg}.options")
    io_, mo = O.IndexOptions(), O.MapOptions()
    mo.flag |= O.MM_F_CIGAR
    wset = build.load_weight_set(str(GOLD / "t_rep_k15.txt"), io_.k)
    mi = build.build_index(fastx.read_all(str(GOLD / "t_ref.fa")), io_.w,
                           io_.k, io_.flag, wset)
    O.update_mid_occ(mo, mi)
    return mi, mo


@pytest.mark.parametrize("n,p", [(0, 1), (7, 1), (8, 2), (9, 4), (3, 5)])
def test_shard_reads(n, p):
    from winnowmap_tpu.parallel import shard_reads as jax_shard
    from winnowmap_tpu_torch.parallel import shard_reads

    shards = [shard_reads(n, i, p) for i in range(p)]
    for i, s in enumerate(shards):
        assert np.array_equal(s, jax_shard(n, i, p))
    assert sorted(np.concatenate(shards).tolist()) == list(range(n))


def test_sharded_map_and_merge_match_jax(tmp_path, monkeypatch):
    from winnowmap_tpu_torch.parallel import map_file_sharded, merge_parts

    reads = _reads_file(tmp_path)
    mi, mo = _index("winnowmap_tpu_torch")
    parts = [str(tmp_path / f"p{i}.txt") for i in range(2)]
    assert sum(map_file_sharded(mi, mo, str(reads), parts[i], i, 2,
                                device="cpu") for i in range(2)) == N_READS
    got = io.StringIO()
    merge_parts(got, parts)

    monkeypatch.setenv("WM_NO_TPU", "1")
    from winnowmap_tpu.parallel import map_file_sharded as jax_sharded
    from winnowmap_tpu.parallel import merge_parts as jax_merge

    jmi, jmo = _index("winnowmap_tpu")
    jparts = [str(tmp_path / f"j{i}.txt") for i in range(2)]
    for i in range(2):
        jax_sharded(jmi, jmo, str(reads), jparts[i], i, 2)
    want = io.StringIO()
    jax_merge(want, jparts)
    assert got.getvalue() and got.getvalue() == want.getvalue()


def _counts_index(cnt):
    return SimpleNamespace(start=np.concatenate([[0], np.cumsum(cnt)]))


def _counts(seed, tail):
    """Occurrence counts of a synthetic index: mostly small, a few large;
    with `tail`, some past 2^16 (the histogram's log2 buckets)."""
    rng = np.random.default_rng(seed)
    cnt = rng.geometric(0.3, 5000).astype(np.int64)
    cnt[rng.integers(0, 5000, 40)] = rng.integers(100, 60000, 40)
    if tail:
        cnt[rng.integers(0, 5000, 600)] = rng.integers(1 << 16, 1 << 20,
                                                       600)
    return cnt


FS = (0.0002, 0.001, 0.01, 0.1, 0.5, 0.0)


def test_global_occ_quantile_local():
    from winnowmap_tpu.parallel import global_occ_quantile as jax_q
    from winnowmap_tpu_torch.index.build import MinimizerIndex
    from winnowmap_tpu_torch.parallel import global_occ_quantile

    for tail in (False, True):
        cnt = _counts(3, tail)
        mi = MinimizerIndex(w=10, k=15)
        mi.start = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
        for f in FS:
            assert global_occ_quantile(mi, f) == mi.cal_max_occ(f) == \
                jax_q(mi, f)
    assert global_occ_quantile(_counts_index(np.zeros(0, np.int64)),
                               0.1) == 2**31 - 1


WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from types import SimpleNamespace
    from winnowmap_tpu_torch.parallel import (global_occ_quantile,
                                              init_distributed)

    rank, world = init_distributed()
    assert dist.get_backend() == "gloo"
    cnts = json.loads(sys.argv[1])
    out = {{}}
    for size in (2, 3, 4):
        group = dist.new_group(list(range(size)))  # every rank calls it
        if rank >= size:
            continue
        for ti, cnt in enumerate(cnts):
            cnt = np.asarray(cnt, np.int64)[rank::size]
            mi = SimpleNamespace(start=np.concatenate([[0], np.cumsum(cnt)]))
            out[f"{{size}}-{{ti}}"] = [global_occ_quantile(mi, f, group)
                                       for f in {fs!r}]
    print("RESULT", json.dumps(out))
    dist.destroy_process_group()
""")


def test_global_occ_quantile_gloo_processes(monkeypatch):
    """Four real processes in one gloo group, and groups of their first 2
    and 3: each rank holds a strided shard of the counts."""
    import jax

    from winnowmap_tpu.parallel import global_occ_quantile as jax_q
    from winnowmap_tpu_torch.parallel import MAXC, N_TAIL

    cnts = [_counts(3, False), _counts(4, True)]
    code = WORKER.format(repo=str(REPO), fs=FS)
    arg = json.dumps([c.tolist() for c in cnts])
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="4")
    procs = [subprocess.Popen([sys.executable, "-c", code, arg],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{outs[r][-3000:]}"
    res = [json.loads(o.split("RESULT ", 1)[1]) for o in outs]

    for ti, cnt in enumerate(cnts):
        # the JAX function, its psum given the global histogram
        big = cnt >= MAXC
        b = cnt.copy()
        b[big] = MAXC + np.minimum(
            (np.log2(cnt[big] / MAXC) * 8).astype(np.int64), N_TAIL - 1)
        hist = np.bincount(b, minlength=MAXC + N_TAIL)
        monkeypatch.setattr(jax.lax, "psum", lambda x, name: hist)
        full = _counts_index(cnt)
        want = [jax_q(full, f, axis_name="i") for f in FS]
        if ti == 0:  # no tail: the exact quantile
            from winnowmap_tpu_torch.index.build import MinimizerIndex

            mi = MinimizerIndex(w=10, k=15)
            mi.start = full.start.astype(np.int64)
            assert want == [mi.cal_max_occ(f) for f in FS]
        for size in (2, 3, 4):
            for r in range(size):
                assert res[r][f"{size}-{ti}"] == want, (size, r, ti)


def test_pack_rows_interop(monkeypatch):
    """Rows the port packs unpack in the JAX package into equal regions,
    and the reverse."""
    from winnowmap_tpu.parallel import sharded as JS
    from winnowmap_tpu_torch.io.fastx import read_all
    from winnowmap_tpu_torch.map.batch import map_batch
    from winnowmap_tpu_torch.parallel import sharded as PS

    reads = read_all(str(GOLD / "t_reads.fa"))[:4]
    seqs, names = [r.seq for r in reads], [r.name for r in reads]
    mi, mo = _index("winnowmap_tpu_torch")
    port = map_batch(mi, mo, seqs, names, device="cpu")
    assert any(r.p is not None for res in port for r in res.regs)
    assert_same_regions(port, JS.unpack_results(*PS.pack_results(port)))

    monkeypatch.setenv("WM_NO_TPU", "1")
    from winnowmap_tpu.map.engine import map_batch_engine

    jmi, jmo = _index("winnowmap_tpu")
    jres = map_batch_engine(jmi, jmo, seqs, names)
    assert_same_regions(jres, PS.unpack_results(*JS.pack_results(jres)))
    for a, b in zip(PS.pack_results(port), JS.pack_results(jres)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
