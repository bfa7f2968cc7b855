"""The port's CLI on two committed goldens that need a preset: map-pb
(`-x map-pb -c`, golden_mappb.paf) and asm20 (`-x asm20 -c`: k = 19, w =
10, dual gap cost, golden_asm20.paf), on the CPU (the plain versions of
the kernels).  The reference mapper maps each read on its own, so the
port's PAF for the first reads of t_reads.fa must equal the golden's lines
of those reads, byte for byte.  chip_smoke.py phase 3 compares the whole
goldens on the card.  (The reference's map-pb preset sets no HPC flag,
options.c as options.set_preset mirrors it, so neither golden sketches
with HPC.)"""
import contextlib
import io
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

GOLD = Path(__file__).resolve().parent / "data" / "golden"
N_READS = 3


def golden_case(tmp_path, argv, golden, n_reads=N_READS):
    """The port CLI's output for argv on the first n_reads reads, and the
    golden's lines for those reads."""
    from winnowmap_tpu_torch.cli import main

    recs = (GOLD / "t_reads.fa").read_text().split(">")[1:n_reads + 1]
    names = {r.split()[0] for r in recs}
    reads = tmp_path / "reads.fa"
    reads.write_text("".join(">" + r for r in recs))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv + [str(GOLD / "t_ref.fa"), str(reads)], device="cpu")
    assert rc == 0
    want = [ln for ln in (GOLD / golden).read_text().splitlines()
            if ln.split("\t", 1)[0] in names]
    assert len(want) >= n_reads
    return buf.getvalue().splitlines(), want


@pytest.mark.parametrize("argv,golden", [
    (["-x", "map-pb", "-c", "-W", "t_rep_k19_pb.txt"], "golden_mappb.paf"),
    (["-x", "asm20", "-c", "-W", "t_rep_k19_empty.txt"], "golden_asm20.paf"),
], ids=["map-pb", "asm20"])
def test_cli_preset_matches_golden(tmp_path, argv, golden):
    argv = argv[:-1] + [str(GOLD / argv[-1])]
    got, want = golden_case(tmp_path, argv, golden)
    assert got == want
