"""All-vs-all overlap (-X -c) and self-mapping without the diagonal (-D -c)
through the port's generator path on the CPU, a few golden reads serving
as both reference and reads, against the JAX CLI's generator path on its
host kernels (WM_NO_TPU=1): byte-equal PAF."""
import pytest
import torch
from test_torch_gen_cli import GOLD, first_reads, port_and_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("flag,n", [("-X", 2), ("-D", 3)])
def test_self_mapping_matches_jax(flag, n, tmp_path_factory, monkeypatch):
    reads = first_reads(tmp_path_factory, n)
    argv = [flag, "-c", "-W", str(GOLD / "t_rep_k15.txt"), str(reads),
            str(reads)]
    got, ref, st = port_and_jax(argv, monkeypatch)
    assert got == ref
    assert "cg:Z:" in got
    assert st["dev_jobs"] > 0 and st.get("host_jobs", 0) == 0
