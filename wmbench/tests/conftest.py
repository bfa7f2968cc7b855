"""Shared helpers: a cell cut down to CPU size (the port's kernels then run
as their plain PyTorch versions)."""
import json
import shutil
from pathlib import Path


ROOT = Path(__file__).resolve().parents[2]


def tiny_base(tmp: Path, cell: str, chrom_bp=600_000, batch_bp=10_000,
              median_bp=2000, pool=1) -> tuple:
    """(manifest, base): a copy of the cell's configuration and mix under
    tmp/wmbench at a size the CPU maps in a minute or two (two chromosomes
    of chrom_bp, satellite arrays of 30 kb, introns under 2 kb, reads of
    median_bp, one batch of batch_bp)."""
    from wmbench import core
    base = tmp / "wmbench"
    (base / "configs").mkdir(parents=True, exist_ok=True)
    (base / "traffic").mkdir(exist_ok=True)
    if not (base / "metrics").exists():
        shutil.copytree(ROOT / "wmbench" / "metrics", base / "metrics")
    man = core.load_manifest(ROOT)
    w = {x["name"]: x for x in man["workloads"]}[cell]
    ce = {x["name"]: x for x in man["configs"]}[w["config"]]
    cfg = json.loads((ROOT / ce["file"]).read_text())
    cfg["chromosomes"], cfg["chrom_bp"] = 2, chrom_bp
    cfg["genome"]["satellite"]["array_bp"] = 30_000
    if cfg["genome"].get("genes"):
        cfg["genome"]["genes"]["intron"]["max_bp"] = 2_000
    (base / "configs" / Path(ce["file"]).name).write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "wmbench" / "traffic" /
                      f"{w['traffic']}.json").read_text())
    mix["batch_bp"], mix["pool_batches"] = batch_bp, pool
    mix["warmup_scale"] = 0.2
    if "length" in mix:
        mix["length"]["median_bp"] = median_bp
        mix["length"]["max_bp"] = 3 * median_bp
    (base / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
    return man, base

