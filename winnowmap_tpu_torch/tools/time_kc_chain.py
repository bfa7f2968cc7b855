"""KC (csrc/kcount.cu) and C1 (csrc/chain.cu) timed on the card, each
launch's time split by kernel with torch.profiler, beside what the same
work costs elsewhere: torch.unique on the block's valid keys for KC,
native.chain_dp on the host for C1.

    python winnowmap_tpu_torch/tools/time_kc_chain.py [--root DIR] [--reps N]

KC runs on a block of 4 Mi codes (numpy seed 20261018: uniform bases with
40 runs of N, as phase 10 (c)'s block of chip_smoke.py, whose keys are
nearly all distinct) at k = 15 and 19, canonical.  C1 runs on single
colinear chains of 10k, 50k, 100k and 300k anchors (numpy seed 20261021)
and on one repeat cluster of 9,000 anchors whose windows pass 8192, under
asm5's stage-2 chain parameters (chip_smoke.py's CHAIN_P2); and on four
chains of 93,000 anchors in one launch, about phase 9's launch.  --root is
the checkout whose port is timed (default: this one): a `git archive` of
another commit unpacked elsewhere times that commit's kernels on the same
inputs, so two commits compare in one call on one card (run them in
turns: parent, change, change, parent).  It prints one JSON line: the
card, and for each input the ms of a launch (CUDA events), each kernel's
share (profiler), and a digest of the outputs, which two commits' kernels
must share.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

# asm5's stage-2 chain parameters (chip_smoke.py's CHAIN_P2)
CHAIN_P2 = dict(max_dist_x=16000, min_dist_x=1000, max_dist_y=16000,
                bw=2000, max_skip=25, max_iter=5000, min_cnt=3, min_sc=40,
                gap_scale=1.0, is_cdna=0)
CHAIN_SIZES = (10_000, 50_000, 100_000, 300_000)
KC_BLOCK = 4 << 20


def by_kernel(torch, fn, reps: int) -> dict:
    """{kernel name: device ms a call} over `reps` calls of fn, from
    torch.profiler's device times (empty where the profiler sees none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us and e.count and "Memcpy" not in e.key:
            out[e.key[:60]] = round(us / 1e3 / reps, 5)
    return out


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def kc_codes(np, n: int):
    rng = np.random.default_rng(20261018)
    c = rng.integers(0, 4, n).astype(np.uint8)
    for at in rng.integers(0, n - 200, 40):
        c[at:at + int(rng.integers(1, 200))] = 255
    return c


def time_kc(torch, np, tools, reps: int) -> dict:
    from winnowmap_tpu_torch.kcount import device as KD

    dev = torch.device("cuda")
    t = torch.from_numpy(kc_codes(np, KC_BLOCK)).to(dev)
    out = {}
    for k in (15, 19):
        km, ct = KD.count_block(t, k)
        keys = KD.block_keys_plain(t, k)
        rec = {"n_valid": len(keys), "n_seg": len(km),
               "digest": digest(km.cpu().numpy(), ct.cpu().numpy()),
               "ms": tools.time_ms(lambda: KD.count_block_launch(t, k), dev,
                                   reps),
               "torch_unique_ms": tools.time_ms(
                   lambda: torch.unique(keys, sorted=True,
                                        return_counts=True), dev, reps),
               "kernels": by_kernel(
                   torch, lambda: KD.count_block_launch(t, k), reps)}
        out[f"kc/k{k}"] = rec
    return out


def time_chain(torch, np, tools, reps: int) -> dict:
    import winnowmap_tpu_torch.native as native
    from winnowmap_tpu_torch.chain import device as CD
    from winnowmap_tpu_torch.chain.check import anchor_set

    dev = torch.device("cuda")
    native.lib()  # the native library's build is not the host's time
    p = CHAIN_P2
    args = (p["max_dist_x"], p["max_dist_y"], p["bw"], p["max_skip"],
            p["is_cdna"], float(np.float32(p["gap_scale"])))
    rng = np.random.default_rng(20261021)
    cases = [(f"chain/{n}", [anchor_set(rng, n, n_clusters=1)])
             for n in CHAIN_SIZES]
    cases.append(("chain/repeat9000",
                  [anchor_set(rng, 9000, repeat=True, n_clusters=1)]))
    cases.append(("chain/4x93000",
                  [anchor_set(rng, 93_000, n_clusters=1) for _ in range(4)]))
    out = {}
    for name, jobs in cases:
        cj = CD.chain_jobs(jobs, p["max_dist_x"], p["min_dist_x"],
                           p["max_iter"], dev)
        fpv = CD.chain_fwd(cj, *args).cpu().numpy()
        t0 = time.perf_counter()
        for ax, ay in jobs:
            native.chain_dp(ax, ay, n_segs=1, **p)
        host_ms = (time.perf_counter() - t0) * 1e3
        win = int((torch.arange(cj.x.numel(), device=dev)
                   - torch.repeat_interleave(cj.off[:-1], cj.off.diff())
                   - cj.st).max())
        out[name] = {"anchors": int(cj.x.numel()), "window_max": win,
                     "digest": digest(fpv),
                     "ms": tools.time_ms(lambda: CD.chain_fwd(cj, *args),
                                         dev, reps),
                     "native_chain_dp_ms": host_ms}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    from winnowmap_tpu_torch import tools

    if not torch.cuda.is_available():
        raise SystemExit("time_kc_chain.py times the kernels on a CUDA card")
    out = {"root": str(args.root), "card": tools.card_line()}
    out.update(time_kc(torch, np, tools, args.reps))
    out.update(time_chain(torch, np, tools, max(1, args.reps // 3)))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
