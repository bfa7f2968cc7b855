"""--sr -c (short-read mode: ungapped gap fills, whole-read extensions)
through the port's generator path on the CPU against the JAX CLI's
generator path on its host kernels (WM_NO_TPU=1), on the first golden
reads: byte-equal PAF."""
import torch
from test_torch_gen_cli import GOLD, first_reads, port_and_jax

torch.set_num_threads(1)


def test_sr_matches_jax(tmp_path_factory, monkeypatch):
    reads = first_reads(tmp_path_factory, 3)
    argv = ["--sr", "-c", "-W", str(GOLD / "t_rep_k15.txt"),
            str(GOLD / "t_ref.fa"), str(reads)]
    got, ref, st = port_and_jax(argv, monkeypatch)
    assert got == ref
    assert len(got.splitlines()) >= 3 and "cg:Z:" in got
    assert st["dev_jobs"] > 0 and st.get("host_jobs", 0) == 0
