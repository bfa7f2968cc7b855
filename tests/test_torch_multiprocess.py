"""parallel/sharded.map_file_partitioned in two real processes joined by
torch.distributed's gloo backend (a free localhost port, as
tests/test_multiprocess.py's): each rank builds one part of t_ref.fa's
index and maps the first 8 reads of t_reads.fa against it on the CPU (the
kernels' plain versions), the regions are all-gathered and rank 0 merges
and writes.  Rank 0's SAM must equal the single-process n_parts=2 run's
(batched: mapping a read alone or in a batch gives the same regions, so
one run serves both cases) and the JAX package's map_file_partitioned
(WM_NO_TPU=1) in the same mode; rank 1 writes nothing."""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLD = REPO / "tests" / "data" / "golden"
N_READS = 8


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from winnowmap_tpu_torch.index.build import load_weight_set
    from winnowmap_tpu_torch.io.fastx import read_all
    from winnowmap_tpu_torch.options import (IndexOptions, MapOptions,
                                             MM_F_CIGAR, MM_F_OUT_SAM)
    from winnowmap_tpu_torch.parallel import init_distributed
    from winnowmap_tpu_torch.parallel.sharded import map_file_partitioned

    rank, world = init_distributed()
    assert world == 2 and dist.get_backend() == "gloo"
    gold = {gold!r}
    io_, mo = IndexOptions(), MapOptions()
    mo.flag |= MM_F_CIGAR | MM_F_OUT_SAM
    mo.sv_aware = False
    wset = load_weight_set(gold + "/t_rep_k15.txt", io_.k)
    records = read_all(gold + "/t_ref.fa")
    with open({out!r} + f".r{{rank}}", "w") as f:
        n = map_file_partitioned(records, io_, mo, wset, {reads!r}, out=f,
                                 batched={batched}, device="cpu")
    print("WORKER-DONE", rank, n)
    dist.destroy_process_group()
""")


def _setup(pkg):
    import importlib

    build = importlib.import_module(f"{pkg}.index.build")
    fastx = importlib.import_module(f"{pkg}.io.fastx")
    O = importlib.import_module(f"{pkg}.options")
    io_, mo = O.IndexOptions(), O.MapOptions()
    mo.flag |= O.MM_F_CIGAR | O.MM_F_OUT_SAM
    mo.sv_aware = False  # the partition and merge are what is held here
    wset = build.load_weight_set(str(GOLD / "t_rep_k15.txt"), io_.k)
    return fastx.read_all(str(GOLD / "t_ref.fa")), io_, mo, wset


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    from winnowmap_tpu_torch.io.fastx import read_all

    path = tmp_path_factory.mktemp("mp") / "reads.fa"
    with open(path, "w") as f:
        for r in read_all(str(GOLD / "t_reads.fa"))[:N_READS]:
            f.write(f">{r.name}\n{r.seq.decode()}\n")
    return path


@pytest.fixture(scope="module")
def single_process(reads):
    """The port's single-process run over the two parts."""
    import io

    from winnowmap_tpu_torch.parallel.sharded import map_file_partitioned

    records, io_, mo, wset = _setup("winnowmap_tpu_torch")
    out = io.StringIO()
    assert map_file_partitioned(records, io_, mo, wset, str(reads), out=out,
                                n_parts=2, device="cpu") == N_READS
    return out.getvalue()


@pytest.mark.parametrize("batched", [False, True])
def test_partitioned_two_gloo_processes(tmp_path, reads, single_process,
                                        batched, monkeypatch):
    out = str(tmp_path / "mp_out")
    code = WORKER.format(repo=str(REPO), gold=str(GOLD), out=out,
                         reads=str(reads), batched=batched)
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{outs[r][-3000:]}"
        assert f"WORKER-DONE {r} {N_READS if r == 0 else 0}" in outs[r]

    got = open(out + ".r0").read()
    assert got.count("\n") >= N_READS
    assert open(out + ".r1").read() == ""
    assert got == single_process

    monkeypatch.setenv("WM_NO_TPU", "1")
    from winnowmap_tpu.parallel.sharded import \
        map_file_partitioned as jax_partitioned

    jrecords, jio, jmo, jwset = _setup("winnowmap_tpu")
    jp = tmp_path / "jax_out"
    with open(jp, "w") as f:
        jax_partitioned(jrecords, jio, jmo, jwset, str(reads), out=f,
                        batched=batched, n_parts=2)
    assert got == jp.read_text()
