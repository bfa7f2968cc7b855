"""map_batch_generator (the port's generator path) against the port's
native-engine path on options both take, device="cpu" (the plain PyTorch
versions of the kernels): --sv-off, SV-aware and one gap cost (-O 4,4
-E 2,2); -x splice is in test_torch_gen_splice.py.  The regions must be equal field for field
(test_torch_engine.reg_key), CIGARs included; every DP job of the
generator path went through the device path."""
from dataclasses import replace

import pytest
import torch
from test_torch_engine import assert_same_results, port_setup

torch.set_num_threads(1)


def _reads(n):
    from test_torch_engine import GOLD
    from winnowmap_tpu_torch.io.fastx import read_all

    reads = read_all(str(GOLD / "t_reads.fa"))[:n]
    return [r.seq for r in reads], [r.name for r in reads]


@pytest.mark.parametrize("case", ["svoff", "sv", "single-cost"])
def test_generator_matches_engine(case):
    from winnowmap_tpu_torch.map.batch import STATS, map_batch_generator
    from winnowmap_tpu_torch.map.engine import map_batch_engine

    mi, mo = port_setup(case != "svoff")
    if case == "single-cost":
        mo = replace(mo, q=4, e=2, q2=4, e2=2)
    seqs, names = _reads(4)
    ref = map_batch_engine(mi, mo, seqs, names, torch.device("cpu"))
    STATS.clear()
    got = map_batch_generator(mi, mo, seqs, names, device="cpu")
    assert_same_results(ref, got)
    assert STATS["dev_jobs"] > 0 and STATS["host_jobs"] == 0

