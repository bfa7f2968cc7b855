"""The debug dumps in the port (utils/dbg.py and its hooks on the generator
path: --print-qname, --print-seeds, --print-aln-seq, --dbg-polish) against
the JAX package: on reads 1-3 of t_reads.fa (the third, of 10,185 bases,
takes the SV-aware MCAS trials, so the trial, stage-2 and PO traces are
written) each trace is byte-equal to the JAX CLI's per-read trace on its
host kernels (WM_NO_TPU=1), although the port advances the reads' and
trials' generators together; and the mapping output with a dump on equals
the JAX CLI's without one, so the dump modes' reference radix anchor
order changes no output here.  ref_radix_argsort equals the JAX package's
on seeded keys with ties.  All comparisons are exact."""
import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLD = REPO / "tests" / "data" / "golden"


@pytest.fixture(scope="module")
def reads_fa(tmp_path_factory):
    recs = (GOLD / "t_reads.fa").read_text().split(">")[2:5]
    p = tmp_path_factory.mktemp("dbg") / "reads.fa"
    p.write_text("".join(">" + r for r in recs))
    return p


def _run(fn, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(list(argv), **kw)
    assert rc == 0
    return out.getvalue(), [ln for ln in err.getvalue().splitlines()
                            if not ln.startswith("[M::")]


@pytest.fixture(scope="module")
def jax_plain(reads_fa):
    """The JAX CLI's PAF of the reads, sv-aware and --sv-off, no dump."""
    import os

    from winnowmap_tpu.cli import main as jax_main

    old = os.environ.get("WM_NO_TPU")
    os.environ["WM_NO_TPU"] = "1"
    try:
        return {sv: _run(jax_main, (["--sv-off"] if sv else []) + [
            "-c", "-W", str(GOLD / "t_rep_k15.txt"), str(GOLD / "t_ref.fa"),
            str(reads_fa)])[0] for sv in (False, True)}
    finally:
        if old is None:
            del os.environ["WM_NO_TPU"]
        else:
            os.environ["WM_NO_TPU"] = old


@pytest.mark.parametrize("flags,prefixes", [
    (["--sv-off", "--print-qname"], ("QR",)),
    (["--print-seeds"], ("QR", "RS", "SD", "CN")),
    (["--sv-off", "--print-aln-seq"], ("QR", "===>", "score=")),
    (["--dbg-polish"], ("QR", "PO")),
], ids=["print-qname", "print-seeds", "print-aln-seq", "dbg-polish"])
def test_dump_trace_matches_jax_cli(flags, prefixes, reads_fa, jax_plain,
                                    monkeypatch):
    """The trace (every stderr line but the log's) byte-equal to the JAX
    CLI's, its kinds of lines all present; the PAF equal to the JAX CLI's
    with the dump and without."""
    from winnowmap_tpu.cli import main as jax_main
    from winnowmap_tpu.utils import dbg as jax_dbg
    from winnowmap_tpu_torch.cli import main as port_main
    from winnowmap_tpu_torch.utils import dbg

    monkeypatch.setenv("WM_NO_TPU", "1")
    # the JAX CLI leaves its dump flag and WM_NO_ENGINE set: both are
    # restored after the test
    monkeypatch.setattr(jax_dbg, "flag", 0)
    monkeypatch.setenv("WM_NO_ENGINE", "")
    argv = flags + ["-c", "-W", str(GOLD / "t_rep_k15.txt"),
                    str(GOLD / "t_ref.fa"), str(reads_fa)]
    got, trace = _run(port_main, argv, device="cpu")
    assert dbg.flag == 0
    want, want_trace = _run(jax_main, argv)
    assert trace == want_trace
    assert got == want == jax_plain["--sv-off" in flags]
    for p in prefixes:
        assert any(ln.startswith(p) for ln in trace), p
    assert sum(ln.startswith("QR\t") for ln in trace) == 3
    if "--dbg-polish" in flags:
        assert any("[FOUND]" in ln for ln in trace)  # an MCAS trial took


def test_ref_radix_argsort_matches_jax():
    """The reference's unstable radix order (ksort.h) on seeded 64-bit keys
    with many ties: below and above the 64-key insertion sort, and deep
    enough to recurse on every byte."""
    from winnowmap_tpu.utils.dbg import ref_radix_argsort as jax_sort
    from winnowmap_tpu_torch.utils.dbg import ref_radix_argsort

    rng = np.random.default_rng(20261018)
    for n in (0, 1, 63, 64, 65, 3000):
        keys = rng.integers(0, 40, n, dtype=np.uint64) << np.uint64(33)
        keys |= rng.integers(0, 1 << 20, n, dtype=np.uint64) & np.uint64(
            0xFF000)
        got = ref_radix_argsort(keys)
        np.testing.assert_array_equal(got, jax_sort(keys))
        assert (np.diff(keys[got].astype(np.float64)) >= 0).all()
