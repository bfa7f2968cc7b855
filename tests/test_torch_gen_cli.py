"""The port's CLI on its generator mapping path (map_batch_generator,
device="cpu": the plain PyTorch versions of the kernels) against the JAX
CLI's generator path on its host kernels (WM_NO_TPU=1): -x splice with
--junc-bed (also byte-equal to golden_splice_junc.paf), --for-only -a and
--rev-only -a on the first golden reads.  Output must be byte-equal."""
import contextlib
import io
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLD = REPO / "tests" / "data" / "golden"


def first_reads(tmp_path_factory, n: int) -> Path:
    """The first n records of t_reads.fa as a FASTA file."""
    recs = (GOLD / "t_reads.fa").read_text().split(">")[1:n + 1]
    p = tmp_path_factory.mktemp("gen") / f"reads{n}.fa"
    p.write_text("".join(">" + r for r in recs))
    return p


def cli_out(fn, argv, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(list(argv), **kw)
    assert rc == 0
    return buf.getvalue()


def port_and_jax(argv, monkeypatch):
    """(port CLI output on the CPU, JAX CLI output on its host kernels),
    with the port's generator-path STATS of the run."""
    from winnowmap_tpu.cli import main as jax_main
    from winnowmap_tpu_torch.cli import main as port_main
    from winnowmap_tpu_torch.map.batch import STATS

    monkeypatch.setenv("WM_NO_TPU", "1")
    STATS.clear()
    got = cli_out(port_main, argv, device="cpu")
    st = dict(STATS)
    return got, cli_out(jax_main, argv), st


def test_junc_bed_matches_golden_and_jax(monkeypatch):
    """-x splice --junc-bed s_junc.bed --junc-bonus 9 -c on the splice
    corpus: K3 jobs carry junction bytes sliced per DP window."""
    argv = ["-x", "splice", "--junc-bed", str(GOLD / "s_junc.bed"),
            "--junc-bonus", "9", "-c", "-W", str(GOLD / "s_rep_k15.txt"),
            str(GOLD / "s_ref.fa"), str(GOLD / "s_reads.fa")]
    got, ref, st = port_and_jax(argv, monkeypatch)
    assert got == (GOLD / "golden_splice_junc.paf").read_text()
    assert got == ref
    assert st["dev_jobs"] > 0 and st.get("host_jobs", 0) == 0
    assert st.get("eng_host_dp_calls", 0) == 0  # not the engine path


@pytest.mark.parametrize("flag", ["--for-only", "--rev-only"])
def test_single_strand_matches_jax(flag, tmp_path_factory, monkeypatch):
    reads = first_reads(tmp_path_factory, 4)
    argv = [flag, "-a", "-W", str(GOLD / "t_rep_k15.txt"),
            str(GOLD / "t_ref.fa"), str(reads)]
    got, ref, st = port_and_jax(argv, monkeypatch)
    assert got == ref
    assert sum(1 for ln in got.splitlines() if not ln.startswith("@")) >= 4
    assert st["dev_jobs"] > 0 and st.get("host_jobs", 0) == 0
