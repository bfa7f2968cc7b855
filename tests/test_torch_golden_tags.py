"""The port's CLI on three committed goldens of PAF's optional fields,
--sv-off against t_rep_k15.txt, on the CPU (the plain versions of the
kernels): `-c --cs` (golden_svoff_cs.paf) and `-c --MD`
(golden_svoff_md.paf) on the first reads of t_reads.fa, whose lines must
equal the golden's lines of those reads, and PAF without a CIGAR
(golden_svoff_nocig.paf: no extension DP) on every read, byte for byte.
chip_smoke.py phase 3 compares the whole goldens on the card."""
from pathlib import Path

import pytest
import torch

from test_torch_golden_presets import golden_case

torch.set_num_threads(1)

GOLD = Path(__file__).resolve().parent / "data" / "golden"
SVOFF = ["--sv-off", "-W", str(GOLD / "t_rep_k15.txt")]


@pytest.mark.parametrize("extra,golden", [
    (["-c", "--cs"], "golden_svoff_cs.paf"),
    (["-c", "--MD"], "golden_svoff_md.paf"),
], ids=["cs", "MD"])
def test_cli_tags_match_golden(tmp_path, extra, golden):
    got, want = golden_case(tmp_path, SVOFF + extra, golden)
    assert got == want


def test_cli_paf_without_cigar_matches_golden(tmp_path):
    got, want = golden_case(tmp_path, SVOFF, "golden_svoff_nocig.paf",
                            n_reads=60)
    assert got == want
    assert "\n".join(got) + "\n" == (GOLD / "golden_svoff_nocig.paf"
                                     ).read_text()
