"""Prebuilt indexes in the port (winnowmap_tpu_torch/index/io.py, mmi.py
and the CLI's -d and target detection) against the JAX package: the
WMTI1 and MMI\\2 writers give the same file bytes as winnowmap_tpu's, their
loaders the same arrays, the reference-written t_ref.mmi loads into the
port's bloom build, and mapping from a dumped index is byte-equal to the
JAX CLI on its host kernels (WM_NO_TPU=1).  Everything is exact: integer
arrays and text output are compared whole.  A loaded .mmi has no weight
set, so those comparisons leave out wset and bloom, as tests/test_mmi.py
does."""
import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLD = REPO / "tests" / "data" / "golden"
N_READS = 3


@pytest.fixture(scope="module")
def reads_fa(tmp_path_factory):
    recs = (GOLD / "t_reads.fa").read_text().split(">")[1:N_READS + 1]
    p = tmp_path_factory.mktemp("idx") / "reads.fa"
    p.write_text("".join(">" + r for r in recs))
    return p


def _out(fn, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(list(argv), **kw)
    assert rc == 0
    return buf.getvalue()


def _builds(bloom: bool):
    """The port's and the JAX package's index of t_ref.fa (k 15, w 50),
    weighted by t_rep_k15.txt's set, and with its bloom table if asked."""
    from winnowmap_tpu.index import build as jb
    from winnowmap_tpu.io.fastx import read_all as jread
    from winnowmap_tpu_torch.index import build as pb
    from winnowmap_tpu_torch.io.fastx import read_all as pread

    rep = str(GOLD / "t_rep_k15.txt")
    ref = str(GOLD / "t_ref.fa")
    jb_bloom = jb.load_weight_bloom(rep, 15) if bloom else None
    pb_bloom = pb.load_weight_bloom(rep, 15) if bloom else None
    jmi = jb.build_index(jread(ref), 50, 15, 0, jb.load_weight_set(rep, 15),
                         weight_bloom=jb_bloom)
    pmi = pb.build_index(pread(ref), 50, 15, 0, pb.load_weight_set(rep, 15),
                         weight_bloom=pb_bloom, device="cpu")
    return jmi, pmi


def _same_index(a, b, weights=True):
    assert (a.w, a.k, a.flag) == (b.w, b.k, b.flag)
    assert [(s.name, s.offset, s.length) for s in a.seqs] == \
        [(s.name, s.offset, s.length) for s in b.seqs]
    names = ["keys", "start", "pos", "codes"] + (["wset"] if weights else [])
    for nm in names:
        x, y = getattr(a, nm), getattr(b, nm)
        assert x.dtype == y.dtype, nm
        np.testing.assert_array_equal(x, y, err_msg=nm)
    if weights:
        assert (a.bloom is None) == (b.bloom is None)
        if a.bloom is not None:
            np.testing.assert_array_equal(a.bloom[0], b.bloom[0])
            assert tuple(a.bloom[1:]) == tuple(b.bloom[1:])


@pytest.mark.parametrize("bloom", [False, True], ids=["set", "bloom"])
def test_wmti_dump_load_match_jax(bloom, tmp_path):
    """dump_index writes the JAX package's bytes; load_index of either
    file gives the JAX loader's arrays, weight set and bloom table
    included."""
    from winnowmap_tpu.index import io as jio
    from winnowmap_tpu_torch.index import io as pio

    jmi, pmi = _builds(bloom)
    pj, pp = tmp_path / "jax.wmi", tmp_path / "port.wmi"
    jio.dump_index(jmi, str(pj))
    pio.dump_index(pmi, str(pp))
    assert pp.read_bytes() == pj.read_bytes()
    assert pio.is_index_file(str(pp)) and not pio.is_index_file(
        str(GOLD / "t_ref.fa"))
    got = pio.load_index(str(pj))
    _same_index(got, jio.load_index(str(pp)))
    _same_index(got, pmi)


def test_mmi_dump_load_match_jax(tmp_path):
    """dump_mmi of the bloom build writes the JAX package's bytes, and
    load_mmi of it and of the reference-written t_ref.mmi gives the JAX
    loader's arrays, equal to the port's bloom build (no weight set)."""
    from winnowmap_tpu.index import mmi as jmmi
    from winnowmap_tpu_torch.index import mmi as pmmi

    jmi, pmi = _builds(True)
    pj, pp = tmp_path / "jax.mmi", tmp_path / "port.mmi"
    jmmi.dump_mmi(jmi, str(pj))
    pmmi.dump_mmi(pmi, str(pp))
    assert pp.read_bytes() == pj.read_bytes()
    assert pmmi.is_mmi_file(str(pp)) and not pmmi.is_mmi_file(
        str(GOLD / "t_ref.fa"))
    for path in (pp, GOLD / "t_ref.mmi"):
        got = pmmi.load_mmi(str(path))
        _same_index(got, jmmi.load_mmi(str(path)))
        _same_index(got, pmi, weights=False)
        assert len(got.wset) == 0 and got.bloom is None


def test_runs_gather_matches_jax():
    """_runs_gather (the MMI\\2 bucket walk's run concatenation) on seeded
    runs, empty ones included."""
    from winnowmap_tpu.index.mmi import _runs_gather as jax_gather
    from winnowmap_tpu_torch.index.mmi import _runs_gather

    rng = np.random.default_rng(20261018)
    src = rng.integers(0, 1 << 62, 5000, dtype=np.uint64)
    cnts = rng.integers(0, 9, 400).astype(np.int64)
    offs = rng.integers(0, 5000 - 9, 400).astype(np.int64)
    np.testing.assert_array_equal(_runs_gather(src, offs, cnts),
                                  jax_gather(src, offs, cnts))
    assert len(_runs_gather(src, offs[:0], cnts[:0])) == 0


@pytest.mark.parametrize("suffix", [".wmi", ".mmi"])
def test_cli_dump_then_map_matches_jax_cli(suffix, reads_fa, tmp_path,
                                           monkeypatch):
    """-d as an index-only run (WMTI1, or MMI\\2 for a path ending in
    .mmi), then --sv-off -c from the dumped index: the dump's bytes and the
    PAF equal the JAX CLI's (the .mmi maps unweighted, as the reference
    does)."""
    from winnowmap_tpu.cli import main as jax_main
    from winnowmap_tpu_torch.cli import main as port_main

    monkeypatch.setenv("WM_NO_TPU", "1")
    rep, ref = str(GOLD / "t_rep_k15.txt"), str(GOLD / "t_ref.fa")
    pj, pp = tmp_path / f"jax{suffix}", tmp_path / f"port{suffix}"
    assert _out(jax_main, ["-W", rep, "-d", str(pj), ref]) == ""
    assert _out(port_main, ["-W", rep, "-d", str(pp), ref],
                device="cpu") == ""
    assert pp.read_bytes() == pj.read_bytes()
    argv = ["--sv-off", "-c", "-W", rep, str(pp), str(reads_fa)]
    got = _out(port_main, argv, device="cpu")
    assert got == _out(jax_main, argv)
    assert len(got.splitlines()) >= N_READS


def test_cli_mmi_golden_target_matches_golden(reads_fa, monkeypatch):
    """-a with the reference-written t_ref.mmi as the target: the SAM
    equals golden_mmi.sam's lines of these reads (header apart from @PG
    whole) and the JAX CLI's output."""
    from winnowmap_tpu.cli import main as jax_main
    from winnowmap_tpu_torch.cli import main as port_main

    monkeypatch.setenv("WM_NO_TPU", "1")
    argv = ["-a", str(GOLD / "t_ref.mmi"), str(reads_fa)]
    got = _out(port_main, argv, device="cpu")
    assert got == _out(jax_main, argv)
    names = {r.split()[0] for r in
             reads_fa.read_text().split(">")[1:]}
    gold = [ln for ln in (GOLD / "golden_mmi.sam").read_text().splitlines()
            if not ln.startswith("@PG") and (ln.startswith("@")
                                            or ln.split("\t")[0] in names)]
    assert [ln for ln in got.splitlines() if not ln.startswith("@PG")] == \
        gold
