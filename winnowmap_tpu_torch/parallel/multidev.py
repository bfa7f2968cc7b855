"""Data-parallel mapping over the visible cards, PyTorch/CUDA port of
winnowmap_tpu/parallel/multidev.py.

A read batch is split into strided shards, one a device; each shard runs
through its own native C++ map engine (map/engine.map_batch_engine) in a
host thread of its own, under torch.cuda.device(d) and a CUDA stream of
its own, so its DP and chain kernels launch on that card, on that stream
(the kernels launch on torch.cuda.current_stream(dev), which is per
thread), and two engines on one card overlap.  Each call's tensors are
made and freed on its thread's stream.  The per-shard results are
rank-merged back into input order: the inverse of the strided shard
assignment, so the output equals one engine's (each read's processing is
independent; only the grouping into device calls changes, and the kernels
give the same result for any grouping).  This is the counterpart of the
reference's kt_for work-stealing over reads (src/kthread.c:30-72) and its
multi-part rank merge (src/map.c:1050-1105).

Driver threads are host-side only: the per-read work runs in each
engine's C++ threads and on the cards.  Several processes compose on top
(parallel/__init__.py shard_reads + merge_parts).
"""
from __future__ import annotations

import threading

import torch

from ..device import resolve_device
from ..map.frag import MapResult


def shard_indices(n_reads: int, n_shards: int) -> list[list[int]]:
    """Strided shard assignment (deterministic; matches shard_reads)."""
    return [list(range(d, n_reads, n_shards)) for d in range(n_shards)]


def visible_cards() -> list[torch.device]:
    """Every visible card; raises when there is none."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def run_on(dev: torch.device, fn, *args, **kw):
    """fn(*args, **kw) with dev as the current card and a new stream of
    dev as the current stream (this thread's); on the CPU, as it is."""
    if dev.type != "cuda":
        return fn(*args, **kw)
    with torch.cuda.device(dev), torch.cuda.stream(torch.cuda.Stream(dev)):
        return fn(*args, **kw)


def run_threads(jobs: list) -> list:
    """Runs each job, a function of no argument, in a host thread of its
    own; returns their results in order, or raises the first error after
    every thread has ended."""
    results: list = [None] * len(jobs)
    errors: list = []

    def run(i):
        try:
            results[i] = jobs[i]()
        except BaseException as e:  # surfaced after join
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), name=f"wm-dev{i}")
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def map_batch_multidev(mi, opt, seqs, qnames, devices=None,
                       chain_min: int | None = None) -> list[MapResult]:
    """Map a read batch data-parallel over `devices` (default: every
    visible card; raises when there is none), one native engine and its
    kernels' stream a device, in threads; devices=["cpu", "cpu"] runs the
    kernels' plain versions.  Equal to map_batch_engine on one device.
    chain_min as map_batch_engine's."""
    from ..map.engine import map_batch_engine

    devs = (visible_cards() if devices is None
            else [resolve_device(d) for d in devices])
    n = len(seqs)
    if len(devs) <= 1 or n < 2:
        return run_on(devs[0], map_batch_engine, mi, opt, seqs, qnames,
                      devs[0], chain_min)
    shards = [(d, idxs) for d, idxs in zip(devs, shard_indices(n, len(devs)))
              if idxs]
    subs = run_threads([
        (lambda d=d, idxs=idxs: run_on(
            d, map_batch_engine, mi, opt, [seqs[i] for i in idxs],
            [qnames[i] for i in idxs], d, chain_min))
        for d, idxs in shards])
    results: list = [None] * n
    for (_, idxs), sub in zip(shards, subs):
        for i, r in zip(idxs, sub):
            results[i] = r
    return results
