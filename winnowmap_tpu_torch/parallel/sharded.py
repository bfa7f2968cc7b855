"""Partitioned-index multi-process mapping, PyTorch/CUDA port of
winnowmap_tpu/parallel/sharded.py (reference shard + reduce template: the
index-part loop main.c:384-424 and merge_hits, src/map.c:1050-1105, here
over a torch.distributed process group).

Each rank builds one index part (a contiguous, bp-balanced slice of the
genome) with the port's build_index on its card (S1 from 1 Mbp), maps
every read against it, and the per-read regions are all-gathered over
the group as host tensors on gloo (pack_results rows, CIGAR blobs); rank
0 then runs the reference's merge (map/pipeline.merge_read_regs:
concatenate with rid shifts, re-sort, reassign primaries, recompute MAPQ
on the union) and writes -- the output of the single-process loop over
the parts, which map_file_partitioned with n_parts also runs.  pack_results
and unpack_results are also the multi-part driver's hit files
(map/pipeline.map_file_multipart).
"""
from __future__ import annotations

import sys

import numpy as np

from ..map.hit import Extra, Reg

# a region's serialized row (the JAX package's layout, so either package
# unpacks the other's rows): int32 fields in REG_I32 order, the flags,
# Extra's fields, the cigar's (offset, length) in a shared u32 blob, and
# div's f32 bits in the last column
REG_I32 = [
    "id", "cnt", "rid", "score", "qs", "qe", "rs", "re", "parent", "subsc",
    "as_", "mlen", "blen", "n_sub", "score0", "mapq", "split", "seg_id",
    "n_segs", "hash",
]
REG_BOOL = ["inv", "rev", "split_inv", "sam_pri", "seg_split", "is_alt"]
REG_P_I32 = ["dp_score", "dp_max", "dp_max2", "n_ambi", "trans_strand"]
ROW_W = len(REG_I32) + len(REG_BOOL) + 1 + len(REG_P_I32) + 3  # +has_p,co,nc
DIV_COL = ROW_W - 1


def pack_results(results):
    """list[MapResult] -> (meta (n, 3) i64, rows (n_regs, ROW_W) i32,
    cigars u32 blob); meta = (n_regs, rep_len, rep_len_defined)."""
    meta = np.zeros((len(results), 3), np.int64)
    rows = []
    cigs = []
    co = 0
    for i, res in enumerate(results):
        meta[i] = (len(res.regs), res.rep_len, int(res.rep_len_defined))
        for r in res.regs:
            row = np.zeros(ROW_W, np.int32)
            for j, f in enumerate(REG_I32):
                v = getattr(r, f)
                row[j] = np.uint32(v & 0xFFFFFFFF).view(np.int32) \
                    if f == "hash" else v
            o = len(REG_I32)
            for j, f in enumerate(REG_BOOL):
                row[o + j] = int(getattr(r, f))
            o += len(REG_BOOL)
            row[o] = int(r.p is not None)
            if r.p is not None:
                for j, f in enumerate(REG_P_I32):
                    row[o + 1 + j] = getattr(r.p, f)
                row[o + 1 + len(REG_P_I32)] = co
                row[o + 2 + len(REG_P_I32)] = len(r.p.cigar)
                cigs.append(np.asarray(r.p.cigar, np.uint32))
                co += len(r.p.cigar)
            row[DIV_COL] = np.float32(r.div).view(np.int32)
            rows.append(row)
    rows = np.stack(rows) if rows else np.zeros((0, ROW_W), np.int32)
    blob = np.concatenate(cigs) if cigs else np.zeros(0, np.uint32)
    return meta, rows, blob


def unpack_results(meta, rows, blob):
    """Inverse of pack_results -> list[MapResult]."""
    from ..map.frag import MapResult

    out = []
    ri = 0
    for n_regs, rep_len, rep_def in meta:
        regs = []
        for _ in range(int(n_regs)):
            row = rows[ri]
            ri += 1
            r = Reg()
            for j, f in enumerate(REG_I32):
                if f == "hash":
                    setattr(r, f, int(np.int32(row[j]).view(np.uint32)))
                else:
                    setattr(r, f, int(row[j]))
            o = len(REG_I32)
            for j, f in enumerate(REG_BOOL):
                setattr(r, f, bool(row[o + j]))
            o += len(REG_BOOL)
            if row[o]:
                r.p = Extra()
                for j, f in enumerate(REG_P_I32):
                    setattr(r.p, f, int(row[o + 1 + j]))
                co = int(row[o + 1 + len(REG_P_I32)])
                nc = int(row[o + 2 + len(REG_P_I32)])
                r.p.cigar = np.asarray(blob[co:co + nc], np.uint32)
            r.div = float(np.int32(row[DIV_COL]).view(np.float32))
            regs.append(r)
        out.append(MapResult(regs, int(rep_len), 0, bool(rep_def)))
    return out


def allgather_padded(arr: np.ndarray, group=None) -> list[np.ndarray]:
    """dist.all_gather of a variable-length host array over `group` (None:
    every rank): the lengths first, then the arrays padded to the longest
    (at least one row: gloo gathers no empty tensor); returns each rank's
    array, unpadded.  A uint32 array travels as int32."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size(group)
    n = torch.tensor([arr.shape[0]], dtype=torch.int64)
    ns = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(ns, n, group=group)
    ns = [int(t) for t in ns]
    m = max(max(ns), 1)
    wire = arr.view(np.int32) if arr.dtype == np.uint32 else arr
    padded = np.zeros((m,) + arr.shape[1:], wire.dtype)
    padded[:arr.shape[0]] = wire
    t = torch.from_numpy(padded)
    got = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(got, t, group=group)
    return [g.numpy()[:c].view(arr.dtype) for g, c in zip(got, ns)]


def split_parts_balanced(all_records, n_parts: int) -> list[list]:
    """A contiguous bp-balanced partition of the reference records: a
    record starts the next part once the current one holds
    ceil(total / n_parts) bases (the JAX package's split)."""
    total_bp = sum(len(r.seq) for r in all_records)
    target = (total_bp + n_parts - 1) // n_parts
    parts = [[] for _ in range(n_parts)]
    pi, acc = 0, 0
    for rec in all_records:
        if acc >= target and pi < n_parts - 1:
            pi += 1
            acc = 0
        parts[pi].append(rec)
        acc += len(rec.seq)
    return parts


def map_file_partitioned(all_records, io_opts, opt, wset, reads_path,
                         out=sys.stdout, batched: bool = True,
                         n_parts: int | None = None, device=None) -> int:
    """Map with the index partitioned over the process group: rank p
    builds part p on `device` (None: its card, cuda:(rank % cards)), maps
    every read, and the regions are all-gathered and merged at rank 0,
    which writes (the other ranks write nothing and return 0).  With
    n_parts, one process loops over the parts itself, on `device` (None:
    the card): the oracle the multi-process run is held to.  batched=False
    maps each read as a batch of its own."""
    import copy

    from ..index.build import build_index
    from ..io.fastx import FastxReader
    from ..io.seqcode import encode
    from ..map.batch import map_batch
    from ..map.frag import MapResult
    from ..map.pipeline import _write_read, merge_read_regs, \
        merged_meta_index
    from ..options import update_mid_occ

    multi = n_parts is None
    if multi:
        import torch.distributed as dist

        from . import rank_device

        n_parts, rank = dist.get_world_size(), dist.get_rank()
        if device is None:
            device = rank_device(rank)
    else:
        rank = 0

    parts = split_parts_balanced(all_records, n_parts)
    part_meta = [[(r.name, len(r.seq)) for r in prt] for prt in parts]
    rid_shift = np.cumsum([0] + [len(prt) for prt in parts])

    def map_part(p):
        mi = build_index(parts[p], io_opts.w, io_opts.k, io_opts.flag, wset,
                         bool(io_opts.flag & 1), device=device)
        opt_p = copy.copy(opt)
        update_mid_occ(opt_p, mi)
        results_all = []
        with FastxReader(reads_path) as reader:
            while True:
                batch = reader.read_batch(opt.mini_batch_size)
                if batch is None:
                    break
                order = sorted(range(len(batch)),
                               key=lambda i: (len(batch[i].seq), i),
                               reverse=True)
                batch = [batch[i] for i in order]
                if batched:
                    res = map_batch(mi, opt_p, [r.seq for r in batch],
                                    [r.name for r in batch], device=device)
                else:
                    res = [map_batch(mi, opt_p, [r.seq], [r.name],
                                     device=device)[0] for r in batch]
                for r in res:
                    for reg in r.regs:
                        reg.rid += int(rid_shift[p])
                results_all.append((batch, res))
        mi.device_codes.clear()  # the part's codes leave the card
        return results_all

    if multi:
        local = map_part(rank)
        # exchange each batch's per-part regions over the group
        per_part_chunks = []
        for batch, res in local:
            gathered = [allgather_padded(a) for a in pack_results(res)]
            per_part_chunks.append(
                (batch, [unpack_results(*(g[p] for g in gathered))
                         for p in range(n_parts)]))
    else:
        all_parts = [map_part(p) for p in range(n_parts)]
        per_part_chunks = [
            (all_parts[0][ci][0], [all_parts[p][ci][1]
                                   for p in range(n_parts)])
            for ci in range(len(all_parts[0]))]

    n_processed = 0
    if rank == 0:
        merged = merged_meta_index(part_meta, io_opts, None)
        # the merged codes, for SAM MD/cs tags: on the writer only
        merged.codes = np.concatenate(
            [np.zeros(0, np.uint8)]
            + [encode(r.seq) for prt in parts for r in prt])
        for batch, per_part in per_part_chunks:
            for k, rec in enumerate(batch):
                regs, rep_len = merge_read_regs(
                    opt, merged.k, [per_part[p][k].regs
                                    for p in range(n_parts)],
                    [per_part[p][k].rep_len for p in range(n_parts)])
                _write_read(merged, opt, rec, MapResult(regs, rep_len, 0),
                            out)
            n_processed += len(batch)
    return n_processed
