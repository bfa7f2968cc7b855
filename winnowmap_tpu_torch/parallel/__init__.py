"""Multi-card and multi-process scaling, PyTorch/CUDA port of
winnowmap_tpu/parallel/ (reference single-node parallelism and its
multi-part index machinery).

The reference scales by pthread work-stealing over reads
(src/kthread.c:30-72) and by splitting oversized references into index
parts whose per-part hits are merged by rank (src/map.c:1050-1105,
src/splitidx.c).  Here:

* data parallelism over reads: each process maps a deterministic strided
  shard of the input (map_file_sharded, shard_reads); within a process,
  map_batch spreads a batch over the visible cards (multidev.py).  Output
  order is restored by a rank merge (merge_parts), as the reference's
  --split-prefix merge does.
* a partitioned index: each process builds one part of the reference and
  maps every read against it; the per-read regions are all-gathered and
  merged at rank 0 (sharded.py).
* global statistics ride the collectives: the occurrence-count quantile
  that sets mid_occ (reference mm_idx_cal_max_occ, src/index.c:173-194)
  needs the global histogram when the index is partitioned.

The collectives run on torch.distributed's gloo backend over host tensors
(packed region rows, CIGAR blobs, histograms): gloo needs no card a rank,
so several ranks share one card (rank r maps on cuda:(r % cards)).
"""
from __future__ import annotations

import os

import numpy as np


def init_distributed() -> tuple[int, int]:
    """Join the process group torchrun's environment describes (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT; init_method "env://", backend
    gloo) and return (rank, world size); (0, 1) without touching
    torch.distributed when WORLD_SIZE is unset or 1."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if world > 1:
        import torch.distributed as dist

        if not dist.is_initialized():
            dist.init_process_group("gloo", init_method="env://",
                                    rank=rank, world_size=world)
    return rank, world


def rank_device(rank: int):
    """The card rank `rank` maps on: cuda:(rank % cards); raises without
    a card."""
    import torch

    from ..device import resolve_device

    resolve_device(None)
    return torch.device("cuda", rank % torch.cuda.device_count())


def shard_reads(n_reads: int, process_id: int, n_processes: int) -> np.ndarray:
    """Deterministic strided read shard for one process (data parallelism
    over reads; the reference's analogue is kt_for task striding,
    src/kthread.c:38-45)."""
    return np.arange(process_id, n_reads, n_processes)


def merge_parts(out, part_paths: list[str]) -> None:
    """Rank-merge per-process output parts back into read order (reference
    --split-prefix merge, src/map.c:1278-1321 / src/splitidx.c).  Each part
    holds lines prefixed with the read rank as '<rank>\\t<line>'."""
    import heapq

    files = [open(p) for p in part_paths]

    def gen(f):
        for line in f:
            rank, _, rest = line.partition("\t")
            yield int(rank), rest

    for _, rest in heapq.merge(*(gen(f) for f in files)):
        out.write(rest)
    for f in files:
        f.close()


# the occurrence histogram: exact buckets below MAXC, log2-spaced
# sub-buckets (8 per octave) for the tail, so highly repetitive indexes
# whose quantile exceeds MAXC - 1 still resolve to within ~9%
MAXC = 1 << 16
N_TAIL = 8 * (31 - 16)  # octaves [2^16, 2^31), 8 sub-buckets each


def global_occ_quantile(mi, f: float, group=None) -> int:
    """mid_occ quantile over the global index when it is partitioned over
    a process group (reference mm_idx_cal_max_occ, src/index.c:173-194):
    each rank's bucketed occurrence histogram summed by dist.all_reduce
    over `group` (torch.distributed.group.WORLD for every rank); without
    a group, the exact local quantile of the partial sort."""
    if f <= 0.0:
        return 2**31 - 1
    cnt = np.diff(mi.start).astype(np.int64)
    if group is None and len(cnt) == 0:
        return 2**31 - 1
    big = cnt >= MAXC
    bucketed = cnt.copy()
    if big.any():
        lg = np.log2(cnt[big].astype(np.float64) / MAXC)
        bucketed[big] = MAXC + np.minimum((lg * 8).astype(np.int64),
                                          N_TAIL - 1)
    local = np.bincount(bucketed, minlength=MAXC + N_TAIL)
    if group is None:
        n = len(cnt)
        kk = min(max(int((1.0 - f) * n), 0), n - 1)
        # a single shard: exact, as mm_idx_cal_max_occ's partial sort
        return int(np.partition(cnt, kk)[kk]) + 1
    import torch
    import torch.distributed as dist

    hist_t = torch.from_numpy(local.astype(np.int64))
    dist.all_reduce(hist_t, op=dist.ReduceOp.SUM, group=group)
    hist = hist_t.numpy()
    n = int(hist.sum())
    if n == 0:
        return 2**31 - 1
    kk = min(max(int((1.0 - f) * n), 0), n - 1)
    csum = np.cumsum(hist)
    v = int(np.searchsorted(csum, kk + 1))
    if v >= MAXC:  # tail bucket: upper edge of the log2 sub-bucket
        v = int(MAXC * 2.0 ** ((v - MAXC + 1) / 8.0))
    return v + 1


def map_file_sharded(mi, opt, path: str, part_path: str, process_id: int,
                     n_processes: int, batched: bool = True,
                     device=None) -> int:
    """Map this process's read shard on `device` (None: the cards, as
    map_batch spreads a batch), writing rank-prefixed lines to part_path
    for merge_parts; batched=False maps each read as a batch of its own.
    Returns reads processed locally."""
    from ..io.fastx import read_all
    from ..map.batch import map_batch
    from ..map.pipeline import _write_read

    records = read_all(path)
    order = shard_reads(len(records), process_id, n_processes)
    shard = [records[i] for i in order]
    for rank, rec in zip(order, shard):
        rec.rid = int(rank)
    if batched:
        results = map_batch(mi, opt, [r.seq for r in shard],
                            [r.name for r in shard], device=device)
    else:
        results = [map_batch(mi, opt, [r.seq], [r.name], device=device)[0]
                   for r in shard]

    class _RankOut:
        def __init__(self, f, rank):
            self.f = f
            self.rank = rank

        def write(self, s):
            for line in s.splitlines():
                self.f.write(f"{self.rank}\t{line}\n")

    with open(part_path, "w") as f:
        for rank, rec, res in zip(order, shard, results):
            _write_read(mi, opt, rec, res, _RankOut(f, int(rank)))
    return len(shard)
