"""S1 (csrc/sketch.cu) timed on the card, on 4,000,000 codes at k = 19
(--k: another k; about phase 5's genome, chip_smoke.py's SKETCH_TIMED),
with the down-weight sets its callers give it.

    python winnowmap_tpu_torch/tools/time_sketch.py [--root DIR] [--reps N]
        [--k K]

The codes are bases drawn with numpy (timed_seq: seed 20261022, A/C/G/T,
lower case and 4% N).  The sets are canonical 19-mers
of those codes: none; 3 (the size of phase 4's repeat list); 1,751 (phase
9's list); 1,000,000, half of them absent from the codes (past the shared
prefix each lookup searches device memory); and the bloom table of the
1,751.  --root is the checkout whose port is timed (default: this one): a
`git archive` of another commit unpacked elsewhere times that commit's S1
on the same codes, so two commits compare in one call on one card (run
them in turns: parent, change, change, parent).  A checkout whose S1 is
the transform alone (transform(codes, k), before the membership and the
order moved onto the card) is timed on the transform.  It prints one JSON
line: the card, and for each case the ms of a wrapper call (CUDA events
over a train of calls), the kernel's own ms (torch.profiler), a digest of
its outputs and how many bases are down-weighted; then sketch_device on
the same bases as one record, HPC off and on, by stage (encode, HPC
compaction, upload, S1, copy-back, the automaton) against native.sketch.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

SKETCH_TIMED = 4_000_000
K = 19
SET_SIZES = {"list3": 3, "list1751": 1751, "set1M": 1_000_000}


def kernel_ms(torch, fn, reps: int) -> float:
    """Device ms a call of fn spends in kernels (torch.profiler; copies
    excluded): S1's own time, without the wrapper's host time, which a
    train of launches timed by CUDA events also holds when the host is
    the slower side."""
    from winnowmap_tpu_torch.tools.time_kc_chain import by_kernel

    return sum(by_kernel(torch, fn, reps).values())


def digest(torch, outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def timed_seq(np) -> bytes:
    """The SKETCH_TIMED bases: A/C/G/T, lower case and 4% N (numpy seed
    20261022)."""
    rng = np.random.default_rng(20261022)
    return rng.choice(list(b"ACGTacgtN"), SKETCH_TIMED,
                      p=[.22, .22, .22, .22, .02, .02, .02, .02, .04]
                      ).astype(np.uint8).tobytes()


def weight_sets(np, canon, k: int = K):
    """{case: sorted u64 set} of canonical k-mers drawn from `canon` (and,
    for the largest, as many values drawn at random below 4^k)."""
    rng = np.random.default_rng(20261023)
    u = np.unique(canon)
    out = {}
    for name, n in SET_SIZES.items():
        if n < 1000:
            out[name] = np.sort(rng.choice(u, n, replace=False))
        else:
            half = rng.choice(u, min(n // 2, len(u)), replace=False)
            rest = rng.integers(0, 1 << (2 * k), n - len(half),
                                dtype=np.uint64)
            out[name] = np.unique(np.concatenate([half, rest]))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--k", type=int, default=K)
    args = ap.parse_args(argv)
    k = args.k
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    from winnowmap_tpu_torch import tools
    from winnowmap_tpu_torch.io.seqcode import encode
    from winnowmap_tpu_torch.sketch import device as SD

    if not torch.cuda.is_available():
        raise SystemExit("time_sketch.py times S1 on a CUDA card")
    dev = torch.device("cuda")
    codes = torch.from_numpy(encode(timed_seq(np))).to(dev)
    out = {"root": str(args.root), "card": tools.card_line(),
           "codes": SKETCH_TIMED, "k": k}
    if not hasattr(SD, "weights_on"):
        fn = lambda: SD.transform(codes, k)  # noqa: E731
        out["transform"] = {
            "digest": digest(torch, fn()),
            "ms": tools.time_ms(fn, dev, args.reps),
            "kernel_ms": kernel_ms(torch, fn, args.reps)}
        print(json.dumps(out), flush=True)
        return
    from winnowmap_tpu_torch.index.build import weight_bloom

    canon_t = SD.transform_plain(codes, k)[4]
    sets = weight_sets(np, canon_t.cpu().numpy().view(np.uint64), k)
    cases = {"none": SD.weights_on(None, None, dev)}
    cases.update({name: SD.weights_on(ws, None, dev)
                  for name, ws in sets.items()})
    cases["bloom1751"] = SD.weights_on(None, weight_bloom(sets["list1751"]),
                                       dev)
    for name, wt in cases.items():
        def fn():
            return SD.sketch(codes, k, wt)

        out[name] = {"set": len(wt.wset), "digest": digest(torch, fn()),
                     "down_weighted": int(SD.flagged_plain(canon_t,
                                                           wt).sum()),
                     "ms": tools.time_ms(fn, dev, args.reps),
                     "kernel_ms": kernel_ms(torch, fn, args.reps)}
    out.update(time_stages(np, SD, k, dev))
    print(json.dumps(out), flush=True)


def time_stages(np, SD, k: int, dev) -> dict:
    """sketch_device on the timed bases as one record (w = 10, no set),
    HPC off and on, by stage on the host clock, against native.sketch
    (equal, else SystemExit)."""
    import winnowmap_tpu_torch.native as native

    seq, none, out = timed_seq(np), np.zeros(0, np.uint64), {}
    for hpc in (False, True):
        SD.sketch_device(seq, 10, k, 0, hpc, none, device=dev)
        stages = {}
        t0 = time.perf_counter()
        got = SD.sketch_device(seq, 10, k, 0, hpc, none, device=dev,
                               stages=stages)
        dev_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = native.sketch(seq, 10, k, 0, hpc, none)
        nat_ms = (time.perf_counter() - t0) * 1e3
        if not all(np.array_equal(a, b) for a, b in zip(want, got)):
            raise SystemExit(f"sketch_device (hpc={hpc}) != native.sketch")
        out[f"sketch_device/{'hpc' if hpc else 'plain'}"] = {
            "ms": dev_ms, "native_sketch_ms": nat_ms,
            "stages_ms": {n: v * 1e3 for n, v in stages.items()}}
    return out


if __name__ == "__main__":
    main()
