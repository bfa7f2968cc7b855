"""K1 (extd, map-ont, flag 0x18) and K4 (extz, -O 4,4 -E 2,2, flag 0x18)
timed by CUDA events on batches of 512 jobs of 1000 bp (numpy seed
20261016) at three band widths: w = 500, chip_smoke.py's phase-2 shape,
and w = 700 and 800, whose rows take the rings of the engine's K1 and K4
calls on the map-ont corpus (768 and 896 lanes; w = 500 takes 640).

    python winnowmap_tpu_torch/tools/time_ext.py [--root DIR] [--reps N]

--root is the checkout whose port is timed (default: this one): a
`git archive` of another commit unpacked elsewhere times that commit's
kernels on the same batches, so two commits compare in one call on one
card (run them in turns: parent, change, change, parent).  It prints one
JSON line: the card, and for each width and kernel the ms a launch and a
digest of its results and direction bytes, which two commits' kernels
must share.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

WIDTHS = (500, 700, 800)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    from winnowmap_tpu_torch import tools
    from winnowmap_tpu_torch.extend import check
    from winnowmap_tpu_torch.map.align import gen_simple_mat

    if not torch.cuda.is_available():
        raise SystemExit("time_ext.py times the kernels on a CUDA card")
    dev = torch.device("cuda")
    out = {"root": str(args.root), "card": tools.card_line()}
    for w in WIDTHS:
        rng = np.random.default_rng(20261016)
        qp, tp, jobs, _, _ = check.random_jobs(rng, [1000] * 512, w, 400)
        for name, prof in (("extd_dp", (2, 4, 4, 2, 24, 1)),
                           ("extz_dp", (2, 4, 4, 2, 4, 2))):
            c = check.OnDevice(dev, qp, tp, jobs,
                               gen_simple_mat(prof[0], prof[1], 1),
                               prof[2:], 0x18, 0)
            res, dirs = c.k1()
            torch.cuda.synchronize()
            digest = hashlib.sha256(res[:, :9].cpu().numpy().tobytes()
                                    + dirs.cpu().numpy().tobytes())
            out[f"{name}/w{w}"] = {
                "ms": tools.time_ms(c.k1, dev, args.reps),
                "digest": digest.hexdigest()[:16]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
