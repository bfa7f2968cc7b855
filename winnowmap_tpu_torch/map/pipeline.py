"""File mapping drivers (reference mm_map_file / worker_pipeline,
src/map.c:983-1276): read batches, longest-first scheduling, ordered output
(map_file); fragments and paired ends (map_file_frag, reference
mm_map_file_frag); an index in parts of -I bases with the per-part hits
merged (map_file_multipart, reference -I and --split-prefix).  Every batch
maps through map/batch.py on the given device."""
from __future__ import annotations

import copy
import pickle
import sys
import tempfile
from pathlib import Path

import numpy as np

from ..device import STATS, span
from ..index.build import MinimizerIndex, SeqMeta, build_index
from ..io import paf as pafmod
from ..io import sam as sammod
from ..io.fastx import FastxReader
from ..io.sam import qname_same
from ..io.seqcode import revcomp_bytes
from ..options import (
    MM_F_ALL_CHAINS,
    MM_F_COPY_COMMENT,
    MM_F_HARD_MLEVEL,
    MM_F_NO_PRINT_2ND,
    MM_F_OUT_SAM,
    MM_F_PAF_NO_HIT,
    MM_F_SAM_HIT_ONLY,
    MM_F_SR,
    MapOptions,
    update_mid_occ,
)
from ..parallel.sharded import pack_results, unpack_results
from ..utils.log import phase_log
from .batch import map_batch, map_batch_frags
from .frag import MapResult
from .hit import hit_sort, select_sub, set_mapq, set_parent, set_sam_pri


def map_file(mi, opt: MapOptions, path: str, out=sys.stdout,
             device=None) -> int:
    """Map all reads in `path` against index `mi`, writing PAF/SAM to `out`.
    Returns the number of reads processed.  Reading a batch and writing its
    records are the spans driver_read and driver_write (device.span)."""
    n_processed = 0
    with FastxReader(path) as reader:
        while True:
            with span(STATS, "driver_read"):
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
            with span(STATS, "driver_write"):
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


CHECK_PAIR_THRES = 1_000_000  # reference bseq.c:30


def _read_frag_batches(paths, mini_batch_bp):
    """Yield frag-mode read batches: multiple files are read in lockstep
    and interleaved (reference mm_bseq_read_frag2, bseq.c:131-158); with
    one file, a fragment's reads are kept in one batch by carrying the
    trailing same-stem group over the batch boundary (the reference reads
    ahead while names match, bseq.c:95-111)."""
    if len(paths) > 1:
        readers = [FastxReader(p) for p in paths]
        try:
            pend = [[] for _ in paths]
            while True:
                batch = []
                size = 0
                while size < mini_batch_bp:
                    for i, rd in enumerate(readers):
                        if not pend[i]:
                            nb = rd.read_batch(mini_batch_bp)
                            pend[i] = list(nb) if nb else []
                    if not all(pend):
                        if any(pend):
                            print("[WARNING] query files have different "
                                  "number of records; extra records "
                                  "skipped.", file=sys.stderr)
                        if batch:
                            yield batch
                        return
                    for i in range(len(readers)):
                        rec = pend[i].pop(0)
                        batch.append(rec)
                        size += len(rec.seq)
                yield batch
        finally:
            for rd in readers:
                rd.close()
    else:
        with FastxReader(paths[0]) as rd:
            carry = []
            while True:
                nb = rd.read_batch(mini_batch_bp)
                if nb is None:
                    if carry:
                        yield carry
                    return
                batch = carry + list(nb)
                carry = []
                # hold back the trailing same-stem group so a fragment
                # never splits across batches
                if batch and len(batch[-1].seq) < CHECK_PAIR_THRES:
                    j = len(batch) - 1
                    while j > 0 and qname_same(batch[j - 1].name,
                                               batch[j].name):
                        j -= 1
                    if j > 0:
                        carry = batch[j:]
                        batch = batch[:j]
                if batch:
                    yield batch


def _group_frags(batch, frag_mode: bool):
    """Group adjacent same-stem reads into fragments (reference
    map.c:1150-1160)."""
    frags = []
    j = 0
    for i in range(1, len(batch) + 1):
        if (i == len(batch) or not frag_mode
                or not qname_same(batch[i - 1].name, batch[i].name)):
            frags.append(batch[j:i])
            j = i
    return frags


def _revcomp_rec(rec):
    rec.seq = revcomp_bytes(rec.seq)
    if rec.qual:
        rec.qual = rec.qual[::-1]


def _write_frag(mi, opt, recs, reses, out) -> None:
    """Emit one fragment's segments (reference pipeline step 2,
    map.c:1186-1208: per-segment records with paired SAM context)."""
    n_seg = len(recs)
    if n_seg == 1:
        _write_read(mi, opt, recs[0], reses[0], out)
        return
    regs_all = [res.regs for res in reses]
    for i, (rec, res) in enumerate(zip(recs, reses)):
        regs = res.regs
        if regs:
            for r in regs:
                assert not r.sam_pri or r.id == r.parent
                if (opt.flag & MM_F_NO_PRINT_2ND) and r.id != r.parent:
                    continue
                if opt.flag & MM_F_OUT_SAM:
                    line = sammod.write_sam(
                        mi, rec, r, regs, opt.flag, res.rep_len,
                        seg_idx=i, n_seg=n_seg, regs_all=regs_all)
                else:
                    line = pafmod.write_paf(
                        mi, rec.name, len(rec.seq), r, opt.flag,
                        res.rep_len, rec.comment,
                        bool(opt.flag & MM_F_COPY_COMMENT), rec=rec)
                out.write(line + "\n")
        elif (opt.flag & MM_F_PAF_NO_HIT) or (
            (opt.flag & MM_F_OUT_SAM)
            and not (opt.flag & MM_F_SAM_HIT_ONLY)
        ):
            if opt.flag & MM_F_OUT_SAM:
                line = sammod.write_sam(
                    mi, rec, None, regs, opt.flag, res.rep_len,
                    seg_idx=i, n_seg=n_seg, regs_all=regs_all)
            else:
                line = pafmod.write_paf(
                    mi, rec.name, len(rec.seq), None, opt.flag,
                    res.rep_len, rec.comment,
                    bool(opt.flag & MM_F_COPY_COMMENT))
            out.write(line + "\n")


def map_file_frag(mi, opt: MapOptions, paths, out=sys.stdout,
                  device=None) -> int:
    """Fragment / paired-end mapping driver (reference mm_map_file_frag,
    src/map.c:1244-1276), as the JAX package's: adjacent same-stem reads
    form one fragment (several files are read in lockstep and
    interleaved); with pe_ori the inner-facing segments are
    reverse-complemented before mapping and flipped back after
    (worker_for, map.c:1009-1048).  No longest-first reshuffle here: the
    reference's (map.c:1127-1143) would separate pair mates before the
    adjacency grouping, and the parity oracle disables it in frag mode.
    Each batch maps through map_batch_frags on `device`."""
    pe_ori = opt.pe_ori
    n_processed = 0
    for batch in _read_frag_batches(paths, opt.mini_batch_size):
        for i, rec in enumerate(batch):
            rec.rid = n_processed + i
        frags = _group_frags(batch, True)
        # pe_ori orientation normalization (reference map.c:1035-1048)
        for fr in frags:
            if len(fr) == 2:
                if pe_ori >> 1 & 1:
                    _revcomp_rec(fr[0])
                if pe_ori & 1:
                    _revcomp_rec(fr[1])
        reses = map_batch_frags(mi, opt, [[r.seq for r in fr]
                                          for fr in frags],
                                [fr[0].name for fr in frags], device=device)
        # flip coordinates back to the original strand (map.c:1040-1048)
        for fr, res in zip(frags, reses):
            if len(fr) == 2:
                for j in (0, 1):
                    if (j == 0 and pe_ori >> 1 & 1) or (j == 1
                                                        and pe_ori & 1):
                        _revcomp_rec(fr[j])
                        qlen = len(fr[j].seq)
                        for r in res[j].regs:
                            r.qs, r.qe = qlen - r.qe, qlen - r.qs
                            r.rev = not r.rev
        for fr, res in zip(frags, reses):
            _write_frag(mi, opt, fr, res, out)
        n_processed += len(batch)
        phase_log("map_file", f"mapped {len(batch)} sequences")
    return n_processed


def split_parts_by_bp(all_records, batch_bp: int):
    """Split the reference into parts of ~batch_bp bases (reference
    mm_idx_reader_read accumulates until sum_len > batch_size,
    index.c:293-295)."""
    parts = []
    cur, cur_len = [], 0
    for rec in all_records:
        cur.append(rec)
        cur_len += len(rec.seq)
        if cur_len > batch_bp:
            parts.append(cur)
            cur, cur_len = [], 0
    if cur:
        parts.append(cur)
    return parts


def merged_meta_index(part_seq_meta, io_opts, part_codes=None):
    """Merged metadata view over index parts for rid-based output
    (names/lengths/codes concatenated; no minimizer tables -- the
    reference's split-merge header/seq lookup, splitidx.c).
    part_seq_meta: per part, list of (name, length)."""
    merged = MinimizerIndex(w=io_opts.w, k=io_opts.k, flag=io_opts.flag)
    off = 0
    for metas in part_seq_meta:
        for name, length in metas:
            merged.seqs.append(SeqMeta(name, off, length))
            off += length
    if part_codes is not None:
        merged.codes = np.concatenate(part_codes)
    return merged


def merge_read_regs(opt: MapOptions, merged_k: int, per_part_regs,
                    per_part_rep_len):
    """Merge one read's per-part regions (reference merge_hits,
    map.c:1050-1105): concatenate, re-sort, reassign primaries and MAPQ
    on the union.  rids must already be shifted into merged space."""
    regs = [reg for regs_p in per_part_regs for reg in regs_p]
    rep_len = max(per_part_rep_len)
    regs = hit_sort(regs, opt.alt_drop)
    set_parent(opt.mask_level, opt.mask_len, regs, opt.a * 2 + opt.b,
               opt.flag & MM_F_HARD_MLEVEL, opt.alt_drop)
    if not (opt.flag & MM_F_ALL_CHAINS):
        regs = select_sub(opt.pri_ratio, merged_k * 2, opt.best_n, regs)
        set_sam_pri(regs)
    set_mapq(regs, opt.min_chain_score, opt.a, rep_len,
             bool(opt.flag & MM_F_SR))
    return regs, rep_len


def map_file_multipart(all_records, io_opts, opt: MapOptions, wset, paths,
                       out=sys.stdout, batch_bp: int = 4_000_000_000,
                       device=None, tmp_dir: str | None = None) -> int:
    """Multi-part index mapping (reference -I + --split-prefix: the
    index-part loop main.c:384-424, per-part hit dumps merged by
    merge_hits, map.c:1050-1105), as the JAX package's: reads are mapped
    against every index part; each read's regions are concatenated with
    rid shifts, rep_len is the maximum over parts, and primary selection
    and MAPQ are recomputed on the union.

    One part at a time (reference index.c:634-679): each part is built by
    build_index on `device` (S1 for a part of 1 Mbp or more), its reads
    mapped there, its per-read results serialized to a temporary file
    under tmp_dir, and its index and its codes' copy on the card dropped
    before the next part is built; the merge runs after the last part, the
    reference codes memory-mapped from a spill file."""
    parts = split_parts_by_bp(all_records, batch_bp)
    n_parts = len(parts)
    part_meta = [[(r.name, len(r.seq)) for r in prt] for prt in parts]
    rid_shift = [0]
    for metas in part_meta:
        rid_shift.append(rid_shift[-1] + len(metas))

    def read_batches():
        """Read batches, longest first, in the same order every pass."""
        n_before = 0
        for path in paths:
            with FastxReader(path) as reader:
                while True:
                    batch = reader.read_batch(opt.mini_batch_size)
                    if batch is None:
                        break
                    for i, rec in enumerate(batch):
                        rec.rid = n_before + i
                    order = sorted(range(len(batch)),
                                   key=lambda i: (len(batch[i].seq), i),
                                   reverse=True)
                    yield [batch[i] for i in order]
                    n_before += len(batch)

    single = n_parts == 1
    tdir = None if single else tempfile.TemporaryDirectory(dir=tmp_dir)
    dumps = []
    try:
        for pi, prt in enumerate(parts):
            # as the JAX package's: a part is weighted by the exact set
            # (no bloom table)
            mi = build_index(prt, io_opts.w, io_opts.k, io_opts.flag, wset,
                             bool(io_opts.flag & 1), device=device)
            opt_p = copy.copy(opt)
            update_mid_occ(opt_p, mi)
            if single:
                n_processed = 0
                for batch in read_batches():
                    res = map_batch(mi, opt_p, [r.seq for r in batch],
                                    [r.name for r in batch], device=device)
                    for rec, r in zip(batch, res):
                        _write_read(mi, opt, rec, r, out)
                    n_processed += len(batch)
                    phase_log("map_file", f"mapped {len(batch)} sequences")
                return n_processed
            # the codes spill to disk: the merge pass memory-maps them for
            # SAM and cs output, so memory holds one part at a time
            with open(Path(tdir.name) / "codes.bin", "ab") as cf:
                cf.write(mi.codes.tobytes())
            dump_path = Path(tdir.name) / f"part{pi}.hits"
            with open(dump_path, "wb") as df:
                for batch in read_batches():
                    res = map_batch(mi, opt_p, [r.seq for r in batch],
                                    [r.name for r in batch], device=device)
                    for r in res:
                        for reg in r.regs:
                            reg.rid += rid_shift[pi]
                    pickle.dump(pack_results(res), df,
                                protocol=pickle.HIGHEST_PROTOCOL)
            dumps.append(dump_path)
            mi.device_codes.clear()  # the part's codes leave the card
            del mi
            phase_log("map_file", f"index part {pi + 1}/{n_parts} mapped")

        merged = merged_meta_index(part_meta, io_opts, None)
        merged.codes = np.memmap(Path(tdir.name) / "codes.bin",
                                 dtype=np.uint8, mode="r")
        # the merge pass (reference merge_hits + splitidx temp-file replay)
        n_processed = 0
        files = [open(p, "rb") for p in dumps]
        try:
            for batch in read_batches():
                per_part = [unpack_results(*pickle.load(f)) for f in files]
                for k, rec in enumerate(batch):
                    regs, rep_len = merge_read_regs(
                        opt, merged.k, [res[k].regs for res in per_part],
                        [res[k].rep_len for res in per_part])
                    _write_read(merged, opt, rec,
                                MapResult(regs, rep_len, 0), out)
                n_processed += len(batch)
                phase_log("map_file", f"merged {len(batch)} sequences "
                                      f"({n_parts} index parts)")
        finally:
            for f in files:
                f.close()
            del merged
        return n_processed
    finally:
        if tdir is not None:
            tdir.cleanup()
