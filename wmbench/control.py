"""Readings for the correctness limits: the program as configured and
the cell's controls, over many seeds, in one process.

    python3 wmbench/control.py --workload <cell> --seeds 11 12 13 ...
        [--controls NAME ...] [--control-seeds N] [--out FILE]

Set-up is made once (card, genome, -W list, index); then for each seed
the cell's pool of batches is made and each batch maps once through the
timed path (map.pipeline.map_file, the window's call, at the cell's batch
size), first as the configuration states ("sound"), then under each of
the mix's `controls` named (all by default) on the first N seeds: a
control's `options` change what the configuration states, its `fault`
(wmbench/faults/<fault>.py) breaks the timed path underneath.  Each is
judged as a run judges its window: the same sample, the same reference.
Prints one JSON line a seed and mode (with the host's load beside the
seconds the pool took), and writes them all to --out.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(manifest, name, seeds, controls=None, control_seeds=None,
             device=None, base=None, log=print) -> list:
    from wmbench import core
    from wmbench import trace as tr
    from winnowmap_tpu_torch.options import update_mid_occ

    kw = {} if base is None else {"base": base}
    cell = core.Cell(manifest, name, seeds[0], device, t_start=T_START,
                     **kw)
    tmp = Path(tempfile.mkdtemp(prefix="wmbench-control-"))
    out = []
    try:
        cell.setup(tr.Spans(), tmp)
        sound = cell.mo
        every = cell.mix.get("controls", [])
        chosen = [core.find_control(cell.mix, c) for c in controls] \
            if controls is not None else every
        modes = [("sound", None, sound)]
        for c in chosen:
            _, mo = core.set_options(cell.cfg, cell.mix, c.get("options"))
            update_mid_occ(mo, cell.mi)
            modes.append((c["name"], c, mo))
        n_ctl = len(seeds) if control_seeds is None else control_seeds
        for k, seed in enumerate(seeds):
            cell.make_pool(seed, tmp)
            for mode, ctl, mo in modes[:1 if k >= n_ctl else None]:
                cell.mo = mo
                undo = core.install_control(ctl)
                outs = []
                t = time.perf_counter()
                try:
                    for b, path in enumerate(cell.pool_paths):
                        o = tmp / f"out{b}.sam"
                        cell.map_one(path, o)
                        outs.append((b, o))
                finally:
                    undo()
                secs = time.perf_counter() - t
                nums, faults, limits = core.check(cell, {"outs": outs})
                row = {"workload": name, "seed": seed, "mode": mode,
                       "numbers": nums, "seconds": secs,
                       "loadavg": os.getloadavg(),
                       "cores": len(os.sched_getaffinity(0))}
                log(json.dumps(row))
                for q, why in faults[:3]:
                    log(f"# fault ({mode}, seed {seed}): {q}: {why}")
                out.append(row)
        cell.mo = sound
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="+",
                    help="names of the mix's controls (default: all)")
    ap.add_argument("--control-seeds", type=int,
                    help="run the controls on the first N seeds only")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("wmbench: no CUDA card", file=sys.stderr)
        return 2
    from wmbench import core
    rows = readings(core.load_manifest(), a.workload, a.seeds, a.controls,
                    a.control_seeds, log=lambda s: print(s, flush=True))
    if a.out:
        Path(a.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
