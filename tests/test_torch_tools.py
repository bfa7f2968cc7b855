"""The port's analysis tools (winnowmap_tpu_torch/tools/minimizer_dist.py
and extract_selected_reads.py) against the JAX package's on the same
inputs: tests/test_tools.py's two tests run on the port, and the port's
sketch_dump(device="cpu") equals the JAX sketch_dump on t_ref.fa, on the
native route (a genome below 1 Mbp) and through S1's plain version
(sketch_min_bp=0)."""
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLD = REPO / "tests" / "data" / "golden"


def test_minimizer_dist_golden_dump(tmp_path):
    """Density profile over the committed reference minimizer dump: the
    in-process sketch_dump agrees with the reference's own dump, max-occ
    filtering counts across the whole dump, the KDE integrates to 1, and
    the TSV equals the JAX tool's byte for byte."""
    from winnowmap_tpu.tools.minimizer_dist import main as jax_main
    from winnowmap_tpu_torch.tools.minimizer_dist import (density_grid,
                                                          filter_max_occ,
                                                          main, sketch_dump)

    want = np.loadtxt(GOLD / "golden_ref_minimizers.txt", dtype=np.int64)
    got = sketch_dump(str(GOLD / "t_ref.fa"), 15, 50,
                      wfile=str(GOLD / "t_rep_k15.txt"), device="cpu")
    assert {tuple(r) for r in got.tolist()} == {tuple(r)
                                                for r in want.tolist()}

    keys, counts = np.unique(got[:, 2], return_counts=True)
    if counts.max() > 1:
        thr = int(counts.max()) - 1
        kept = filter_max_occ(got, thr)
        kk, kc = np.unique(kept[:, 2], return_counts=True)
        assert kc.max() <= thr

    grid, dens = density_grid(got[got[:, 0] == 0][:, 1], bw=500.0)
    area = np.trapezoid(dens, grid)
    assert abs(area - 1.0) < 1e-3

    out, jout = tmp_path / "density.tsv", tmp_path / "jax.tsv"
    args = ["--input", str(GOLD / "golden_ref_minimizers.txt"), "--rid",
            "0", "--max-occ", "3"]
    assert main(args + ["--out", str(out)]) == 0
    assert jax_main(args + ["--out", str(jout)]) == 0
    rows = [ln for ln in out.read_text().splitlines()
            if not ln.startswith("#")]
    assert len(rows) == 512
    assert out.read_bytes() == jout.read_bytes()


@pytest.mark.parametrize("sketch_min_bp", [None, 0], ids=["native", "s1"])
@pytest.mark.parametrize("wfile", [None, "t_rep_k15.txt"],
                         ids=["noset", "set"])
def test_sketch_dump_matches_jax(sketch_min_bp, wfile):
    """The port's sketch_dump on t_ref.fa, in the JAX tool's row order,
    with and without the down-weight list, by the native sketch and by
    S1's plain version."""
    from winnowmap_tpu.tools.minimizer_dist import sketch_dump as jax_dump
    from winnowmap_tpu_torch.tools.minimizer_dist import sketch_dump

    w = None if wfile is None else str(GOLD / wfile)
    want = jax_dump(str(GOLD / "t_ref.fa"), 15, 50, wfile=w)
    got = sketch_dump(str(GOLD / "t_ref.fa"), 15, 50, wfile=w,
                      device="cpu", sketch_min_bp=sketch_min_bp)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_minimizer_dist_fasta_cli_matches_jax(tmp_path):
    """--fasta mode end to end: the port's TSV (device cpu) equals the JAX
    tool's."""
    from winnowmap_tpu.tools.minimizer_dist import main as jax_main
    from winnowmap_tpu_torch.tools.minimizer_dist import main

    args = ["--fasta", str(GOLD / "t_ref.fa"), "-W",
            str(GOLD / "t_rep_k15.txt"), "--rid", "1", "--bw", "300"]
    out, jout = tmp_path / "p.tsv", tmp_path / "j.tsv"
    assert main(args + ["--out", str(out), "--device", "cpu"]) == 0
    assert jax_main(args + ["--out", str(jout)]) == 0
    assert out.read_bytes() == jout.read_bytes()


def test_extract_selected_reads(tmp_path):
    from winnowmap_tpu.tools.extract_selected_reads import \
        extract as jax_extract
    from winnowmap_tpu_torch.tools.extract_selected_reads import extract, \
        main

    paf = tmp_path / "o.paf"
    paf.write_text("r1\t100\t0\t90\t+\tc\t1\t2\t3\t4\t5\t60\n"
                   "r2\t100\t0\t90\t+\tc\t1\t2\t3\t4\t5\t60\n"
                   "r10\t100\t0\t90\t+\tc\t1\t2\t3\t4\t5\t60\n")
    ids = tmp_path / "ids.txt"
    ids.write_text("r1\nr10\n")
    out, jout = tmp_path / "f.paf", tmp_path / "j.paf"
    assert extract(str(paf), str(ids), str(out)) == 2
    names = [ln.split("\t")[0] for ln in out.read_text().splitlines()]
    assert names == ["r1", "r10"]  # exact-id match: r2 dropped, not "r1*"
    assert jax_extract(str(paf), str(ids), str(jout)) == 2
    assert out.read_bytes() == jout.read_bytes()
    assert main(["--paf", str(paf), "--ids", str(ids),
                 "--out", str(out)]) == 0
