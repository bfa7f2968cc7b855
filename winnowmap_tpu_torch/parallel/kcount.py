"""Multi-card k-mer counting: blocks round-robin over the devices, then a
rank merge.  PyTorch/CUDA port of winnowmap_tpu/parallel/kcount.py.

Block streaming (kcount/device.py) makes counting embarrassingly
parallel: every block of base codes is an independent encode -> sort ->
run-length unit (KC), so blocks go round-robin over the device list, each
slot of the list on a CUDA stream of its own (two slots on one card
overlap), at most 2 x slots in flight, each collected in launch order.
Each slot's sorted runs, and then the slots' partial counts, reduce with
the out-of-core counter's chunked two-pointer merge (outofcore._merge_two)
-- the counting analogue of the mapper's shard + rank merge (reference
template: the 64-way file-slice OpenMP loop,
ext/meryl/src/meryl/meryl.C:253-262, and the sort + dump + merge batching
of merylOp-count.C:577-644).  The result equals count_kmers' for any
device list.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import resolve_device
from ..kcount import KmerCounts
from ..kcount import device as _kdev
from ..kcount.outofcore import _merge_two, _Run

_MERGE_CHUNK = 1 << 22


def _reduce_runs(runs: list[_Run]) -> _Run | None:
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(_merge_two(runs[i], runs[i + 1], None, _MERGE_CHUNK))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0] if runs else None


def count_kmers_multidev(records, k: int, direction: str = "canonical",
                         devices=None) -> KmerCounts:
    """Count k-mers with KC's blocks round-robin over `devices` (default:
    every visible card; raises when there is none); a "cpu" entry runs
    KC's plain version."""
    from .multidev import visible_cards

    _kdev._check_args(k, direction)
    devs = (visible_cards() if devices is None
            else [resolve_device(d) for d in devices])
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
               for d in devs]
    inflight: list = []  # (slot, uniq, counts, n_seg), launch order
    per_dev: list[list[_Run]] = [[] for _ in devs]

    def on(slot):
        """The slot's card and stream as current (nothing on the CPU)."""
        if streams[slot] is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(devs[slot]))
        stack.enter_context(torch.cuda.stream(streams[slot]))
        return stack

    def collect(item):
        slot, uniq, counts, n_seg = item
        with on(slot):
            n = int(n_seg)
            if n:
                per_dev[slot].append(_Run(
                    uniq[:n].cpu().numpy().view(np.uint64),
                    counts[:n].cpu().numpy(), None))

    d = 0
    for buf in _kdev.iter_code_blocks(records, k):
        if len(buf) < k:
            continue
        with on(d):
            codes = torch.from_numpy(buf).to(devs[d])
            if streams[d] is None:
                uniq, counts = _kdev.count_block(codes, k, direction)
                n_seg = len(uniq)
            else:
                uniq, counts, n_seg = _kdev.count_block_launch(codes, k,
                                                               direction)
        inflight.append((d, uniq, counts, n_seg))
        if len(inflight) > 2 * len(devs):
            collect(inflight.pop(0))
        d = (d + 1) % len(devs)
    for item in inflight:
        collect(item)

    # each slot's partial reduce, then the merge across slots
    total = _reduce_runs([r for runs in per_dev if runs
                          for r in [_reduce_runs(runs)]])
    if total is None:
        return KmerCounts(k, np.zeros(0, np.uint64), np.zeros(0, np.int64))
    return KmerCounts(k, np.asarray(total.kmers), np.asarray(total.counts))
