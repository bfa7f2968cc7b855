"""The port's meryl side tools (meryl_lookup_cli, meryl_analyze_cli,
meryl_import_cli, position_lookup_cli) on a database counted by the
port's meryl_cli (KC's plain version, device="cpu") from t_ref.fa: the
seven meryl-lookup reports equal their golden_lookup_* files (the
reference tool's output, text or md5), an imported print equals the
print, and meryl-analyze's histograms and position-lookup's reports are
byte-equal to the JAX package's tools on the same database (the
reference binaries the JAX test compares with are not here)."""
import contextlib
import hashlib
import io
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLD = REPO / "tests" / "data" / "golden"
MODES = ("existence", "include", "exclude", "bed", "bed-runs", "wig-count",
         "wig-depth")


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    from winnowmap_tpu_torch.meryl_cli import main as meryl_main

    path = tmp_path_factory.mktemp("meryl_side") / "db"
    assert meryl_main(["count", "k=15", "output", str(path),
                       str(GOLD / "t_ref.fa")], device="cpu") == 0
    return path


def _print(db_path) -> str:
    from winnowmap_tpu_torch.meryl_cli import main as meryl_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert meryl_main(["print", str(db_path)]) == 0
    return buf.getvalue()


@pytest.mark.parametrize("mode", MODES)
def test_lookup_matches_golden(db, tmp_path, mode):
    from winnowmap_tpu_torch.meryl_lookup_cli import main

    out = tmp_path / f"{mode}.out"
    assert main([f"-{mode}", "-sequence", str(GOLD / "t_reads.fa"),
                 "-output", str(out), "-mers", str(db)]) == 0
    data = out.read_bytes()
    if mode == "existence":
        assert data.decode() == (GOLD / "golden_lookup_existence.txt"
                                 ).read_text()
    else:
        want = (GOLD / f"golden_lookup_{mode}.md5").read_text().strip()
        assert hashlib.md5(data).hexdigest() == want


def test_import_round_trip(db, tmp_path):
    """meryl-import of the database's print, printed again, is the print;
    the imported database equals the one meryl_cli's import operation
    makes, the port's and the JAX package's."""
    from winnowmap_tpu.meryl_cli import main as jax_meryl
    from winnowmap_tpu_torch.kcount import KmerCounts
    from winnowmap_tpu_torch.meryl_import_cli import main

    text = _print(db)
    dump = tmp_path / "dump.txt"
    dump.write_text(text)
    imp = tmp_path / "imp"
    assert main(["-k", "15", "-kmers", str(dump), "-output", str(imp)]) == 0
    assert _print(imp) == text
    op = tmp_path / "op"
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_meryl(["import", "-k", "15", "-kmers", str(dump),
                          "-output", str(op)]) == 0
    a, b = KmerCounts.load(str(imp)), KmerCounts.load(str(op))
    assert (a.kmers == b.kmers).all() and (a.counts == b.counts).all()


@pytest.mark.parametrize("mode", ["-gc", "-ga"])
def test_analyze_matches_jax(db, tmp_path, mode):
    from winnowmap_tpu.meryl_analyze_cli import main as jax_main
    from winnowmap_tpu_torch.meryl_analyze_cli import main

    assert main(["-mers", str(db), "-prefix", str(tmp_path / "p"),
                 mode]) == 0
    assert jax_main(["-mers", str(db), "-prefix", str(tmp_path / "j"),
                     mode]) == 0
    exts = ["GC.hist"] if mode == "-gc" else ["GA.hist", "TC.hist",
                                               "GA_TC.hist"]
    for ext in exts:
        got = (tmp_path / f"p.{ext}").read_bytes()
        assert got and got == (tmp_path / f"j.{ext}").read_bytes(), ext


def test_position_lookup_matches_jax(db, tmp_path):
    from winnowmap_tpu.position_lookup_cli import main as jax_main
    from winnowmap_tpu_torch.position_lookup_cli import main

    for tool, tag in ((main, "p"), (jax_main, "j")):
        assert tool(["-m", str(db), "-s", str(GOLD / "t_ref.fa"),
                     "-hpq", str(tmp_path / f"{tag}_hpq"),
                     "-mpb", str(tmp_path / f"{tag}_mpb"),
                     "-qpb", str(tmp_path / f"{tag}_qpb"),
                     str(GOLD / "t_reads.fa")]) == 0
    for f in ("hpq", "mpb", "qpb"):
        got = (tmp_path / f"p_{f}").read_bytes()
        assert got and got == (tmp_path / f"j_{f}").read_bytes(), f
