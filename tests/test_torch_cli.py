"""The port's CLI against the JAX package's: `-a` SAM on the first golden
reads must be byte-identical to `python -m winnowmap_tpu.cli -a` on its host
kernels (WM_NO_TPU=1), and so must single-cost (`-O 4,4 -E 2,2 -c`) PAF;
a preset the port does not take (-x sr, which the JAX package refuses too)
must exit with a clear error instead of running something else.  The
generator path's flags are in test_torch_gen_*.py; -d and prebuilt
indexes in test_torch_index_io.py, -I and --split-prefix in
test_torch_multipart.py, fragments (--frag, -F, several query files) in
test_torch_pe.py and the debug dumps in test_torch_dbg.py."""
import contextlib
import io
import re
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLD = REPO / "tests" / "data" / "golden"
N_READS = 6


@pytest.fixture(scope="module")
def reads_fa(tmp_path_factory):
    recs = (GOLD / "t_reads.fa").read_text().split(">")[1:N_READS + 1]
    p = tmp_path_factory.mktemp("cli") / "reads.fa"
    p.write_text("".join(">" + r for r in recs))
    return p


def _out(fn, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(list(argv), **kw)
    assert rc == 0
    return buf.getvalue()


@pytest.mark.parametrize("extra", [[], ["--sv-off"]], ids=["sv", "svoff"])
def test_cli_sam_matches_jax_cli(extra, reads_fa, monkeypatch):
    from winnowmap_tpu.cli import main as jax_main
    from winnowmap_tpu_torch.cli import main as port_main

    monkeypatch.setenv("WM_NO_TPU", "1")
    argv = extra + ["-a", "-W", str(GOLD / "t_rep_k15.txt"),
                    str(GOLD / "t_ref.fa"), str(reads_fa)]
    ref = _out(jax_main, argv)
    got = _out(port_main, argv, device="cpu")
    assert got == ref
    assert sum(1 for ln in got.splitlines() if not ln.startswith("@")) >= \
        N_READS


def test_cli_no_end_flt_matches_jax_cli(reads_fa, monkeypatch):
    """--no-end-flt (keep the seeds at a chain's ends that the end filter
    drops) with -c: the PAF is byte-equal to the JAX CLI's on its host
    kernels."""
    from winnowmap_tpu.cli import main as jax_main
    from winnowmap_tpu_torch.cli import main as port_main

    monkeypatch.setenv("WM_NO_TPU", "1")
    argv = ["-c", "-W", str(GOLD / "t_rep_k15.txt"), "--no-end-flt",
            str(GOLD / "t_ref.fa"), str(reads_fa)]
    got = _out(port_main, argv, device="cpu")
    assert got == _out(jax_main, argv)
    assert len(got.splitlines()) >= N_READS


@pytest.mark.parametrize("argv", [["-x", "sr"]], ids=["sr"])
def test_cli_unported_flags_exit_with_error(argv, capsys):
    """-x sr is no preset of the JAX package either (its set_preset raises
    on it): the port's CLI refuses it with a clear error."""
    from winnowmap_tpu_torch.cli import main as port_main

    rc = port_main(argv + [str(GOLD / "t_ref.fa"), str(GOLD / "t_reads.fa")],
                   device="cpu")
    assert rc == 2
    assert "not yet ported" in capsys.readouterr().err


def test_cli_single_cost_matches_jax_cli(reads_fa, monkeypatch):
    """-O 4,4 -E 2,2 (one gap cost: the extz kernel) with -c: the PAF is
    byte-equal to the JAX CLI's on its host kernels."""
    from winnowmap_tpu.cli import main as jax_main
    from winnowmap_tpu_torch.cli import main as port_main

    monkeypatch.setenv("WM_NO_TPU", "1")
    argv = ["-O", "4,4", "-E", "2,2", "-c", "-W",
            str(GOLD / "t_rep_k15.txt"), str(GOLD / "t_ref.fa"),
            str(reads_fa)]
    got = _out(port_main, argv, device="cpu")
    assert got == _out(jax_main, argv)
    assert len(got.splitlines()) >= N_READS
    assert "cg:Z:" in got


def _no_pg(s):
    return [ln for ln in s.splitlines() if not ln.startswith("@PG")]


@pytest.mark.parametrize("extra,golden", [
    (["-c"], "golden_splice.paf"), (["-a"], "golden_splice.sam"),
    (["-c", "--cs"], "golden_splice_cs.paf"),
], ids=["paf", "sam", "cs"])
def test_cli_splice_matches_goldens_and_jax_cli(extra, golden, monkeypatch):
    """-x splice on the whole splice corpus: PAF and --cs byte-equal to the
    reference goldens, SAM equal apart from @PG (N ops, ts:A: tags, ~gt..ag
    introns), and all three byte-equal to the JAX CLI."""
    from winnowmap_tpu.cli import main as jax_main
    from winnowmap_tpu_torch.cli import main as port_main

    monkeypatch.setenv("WM_NO_TPU", "1")
    argv = ["-x", "splice"] + extra + [
        "-W", str(GOLD / "s_rep_k15.txt"), str(GOLD / "s_ref.fa"),
        str(GOLD / "s_reads.fa")]
    got = _out(port_main, argv, device="cpu")
    gold = (GOLD / golden).read_text()
    if golden.endswith(".sam"):
        assert _no_pg(got) == _no_pg(gold)
    else:
        assert got == gold
    assert got == _out(jax_main, argv)
    assert re.search(r"[0-9]+N", got)  # introns in the CIGARs


def test_cli_splice_needs_a_card_unless_cpu(capsys):
    """Without --device cpu the spliced path runs on the card, and raises
    where there is none instead of running on the CPU."""
    from winnowmap_tpu_torch.cli import main as port_main

    if torch.cuda.is_available():
        pytest.skip("a card is present; the CUDA path is tested in "
                    "test_torch_gpu.py")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main(["-x", "splice", "-c", "-W", str(GOLD / "s_rep_k15.txt"),
                   str(GOLD / "s_ref.fa"), str(GOLD / "s_reads.fa")])
