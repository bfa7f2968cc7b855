"""File mapping driver (reference mm_map_file / worker_pipeline,
src/map.c:983-1276): read batches, longest-first scheduling, ordered output.
Single-part index, batched path only."""
from __future__ import annotations

import sys

from ..io import paf as pafmod
from ..io import sam as sammod
from ..io.fastx import FastxReader
from ..options import (
    MM_F_COPY_COMMENT,
    MM_F_NO_PRINT_2ND,
    MM_F_OUT_SAM,
    MM_F_PAF_NO_HIT,
    MM_F_SAM_HIT_ONLY,
    MapOptions,
)
from ..utils.log import phase_log
from .batch import map_batch


def map_file(mi, opt: MapOptions, path: str, out=sys.stdout,
             device=None) -> int:
    """Map all reads in `path` against index `mi`, writing PAF/SAM to `out`.
    Returns the number of reads processed."""
    n_processed = 0
    with FastxReader(path) as reader:
        while True:
            batch = reader.read_batch(opt.mini_batch_size)
            if batch is None:
                break
            for i, rec in enumerate(batch):
                rec.rid = n_processed + i
            # longest-first scheduling, ties -> later read first
            # (reference map.c:1124-1143; this changes output order)
            order = sorted(range(len(batch)),
                           key=lambda i: (len(batch[i].seq), i), reverse=True)
            batch = [batch[i] for i in order]
            results = map_batch(mi, opt, [r.seq for r in batch],
                                [r.name for r in batch], device=device)
            for rec, res in zip(batch, results):
                _write_read(mi, opt, rec, res, out)
            n_processed += len(batch)
            phase_log("map_file", f"mapped {len(batch)} sequences")
    return n_processed


def _write_read(mi, opt, rec, res, out) -> None:
    regs = res.regs
    if regs:
        for r in regs:
            assert not r.sam_pri or r.id == r.parent
            if (opt.flag & MM_F_NO_PRINT_2ND) and r.id != r.parent:
                continue
            if opt.flag & MM_F_OUT_SAM:
                line = sammod.write_sam(mi, rec, r, regs, opt.flag,
                                        res.rep_len)
            else:
                line = pafmod.write_paf(
                    mi, rec.name, len(rec.seq), r, opt.flag, res.rep_len,
                    rec.comment, bool(opt.flag & MM_F_COPY_COMMENT), rec=rec)
            out.write(line + "\n")
    elif (opt.flag & MM_F_PAF_NO_HIT) or (
            (opt.flag & MM_F_OUT_SAM) and not (opt.flag & MM_F_SAM_HIT_ONLY)):
        if opt.flag & MM_F_OUT_SAM:
            line = sammod.write_sam(mi, rec, None, regs, opt.flag,
                                    res.rep_len)
        else:
            line = pafmod.write_paf(
                mi, rec.name, len(rec.seq), None, opt.flag, res.rep_len,
                rec.comment, bool(opt.flag & MM_F_COPY_COMMENT))
        out.write(line + "\n")
