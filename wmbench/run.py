"""Run one cell of the benchmark once and print its result.

    python3 wmbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  Set-up (the card, the builds, the genome,
the -W list, the index, the reads, a warm-up batch) counts as setup_s;
then the cell's traffic maps through winnowmap_tpu_torch's file driver for
--seconds; then the plain reference judges the output.  The last line of
standard output is one JSON object (correct, attempted, failed, metrics,
device, with --trace 1 breakdown, and last the numbers compared with their
limits); the numbers compared also end standard error.  Without a CUDA
card, or with fewer than the cell asks for, it exits 2 and prints no
result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from wmbench import core

    manifest = core.load_manifest()
    w = {c["name"]: c for c in manifest["workloads"]}.get(a.workload)
    if w is None:
        print(f"wmbench: no workload {a.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"wmbench: {a.workload} needs {w['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print("# card: " + json.dumps(core.card_info()), flush=True)

    def log(line):
        print(line, flush=True)

    out = core.run(manifest, a.workload, a.seed, a.seconds, bool(a.trace),
                   log=log, t_start=T_START)
    bad = core.forbidden_modules()
    if bad:
        print(f"wmbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} = {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
