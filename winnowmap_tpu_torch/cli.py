"""winnowmap-compatible command line for the PyTorch/CUDA port (reference
src/main.c).

    python -m winnowmap_tpu_torch.cli [-x map-ont|map-pb|asm5|asm10|asm20|
        splice|splice:hq|cdna] [-a|-c] [--sv-off] [--junc-bed genes.bed]
        [-X|-D] [--for-only|--rev-only] [--sr] [-d index.wmi|index.mmi]
        [-I 4G] [--split-prefix dir/prefix] [--frag yes|no] [-F 800]
        [--print-qname|--print-seeds|--print-aln-seq|--dbg-polish]
        [--device cuda|cpu] -W rep.txt ref.fa|index [reads.fa [mates.fa]]

Maps reads against a reference built on the fly or loaded from an index
(the JAX package's WMTI1 or the reference's MMI\2, detected by their
magic) and writes PAF or SAM, with the same flags and output as
winnowmap_tpu.cli.  -d writes the index (MMI\2 for a path ending in .mmi,
WMTI1 otherwise), with or without queries.  A reference longer than -I
bases maps part by part (map/pipeline.map_file_multipart); several query
files, or --frag yes, map as fragments (paired ends).  Single-cost gap
profiles (-O q,q -E e,e) run the extz kernel, spliced presets exts, the
others extd.  --junc-bed, -X, -D, --for-only, --rev-only, --sr, the debug
dumps and fragments of several segments map through the generator path
(map/batch.py), the other options through the native engine.  The DP,
the chains of 50,000 anchors or more and the sketch transform of a
reference (or index part) of 1 Mbp or more run on the CUDA card; --device
cpu runs the kernels' plain PyTorch versions (and chains every read on the
host).
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

from . import __version__
from .index.build import (build_index, load_weight_bloom, load_weight_set,
                          read_bed)
from .index.io import dump_index, is_index_file, load_index
from .index.mmi import dump_mmi, is_mmi_file, load_mmi
from .io.fastx import read_all
from .io.sam import sam_header
from .map.pipeline import (map_file, map_file_frag, map_file_multipart,
                           merged_meta_index)
from .options import (
    MM_F_ALL_CHAINS,
    MM_F_CIGAR,
    MM_F_COPY_COMMENT,
    MM_F_EQX,
    MM_F_FOR_ONLY,
    MM_F_FRAG_MODE,
    MM_F_HARD_MLEVEL,
    MM_F_LONG_CIGAR,
    MM_F_NO_DIAG,
    MM_F_NO_DUAL,
    MM_F_NO_END_FLT,
    MM_F_NO_LJOIN,
    MM_F_NO_PRINT_2ND,
    MM_F_OUT_CG,
    MM_F_OUT_CS,
    MM_F_OUT_CS_LONG,
    MM_F_OUT_MD,
    MM_F_OUT_SAM,
    MM_F_PAF_NO_HIT,
    MM_F_REV_ONLY,
    MM_F_SAM_HIT_ONLY,
    MM_F_SOFTCLIP,
    MM_F_SPLICE,
    MM_F_SR,
    IndexOptions,
    MapOptions,
    check_options,
    set_preset,
    update_mid_occ,
)
from .utils import dbg
from .utils.log import cputime, peakrss, phase_log, realtime, warn

USAGE = """Usage: python -m winnowmap_tpu_torch.cli [options] <target.fa|index>
       [query.fa] [...]
The PyTorch/CUDA port of winnowmap-tpu (Winnowmap v2.03 capabilities);
flags mirror the reference (see winnowmap --help)."""

PRESETS = ("map-ont", "map-pb", "map-pb-clr", "asm5", "asm10", "asm20",
           "splice", "splice:hq", "cdna")

# the debug dumps' flags (reference main.c; --print-seeds and
# --print-aln-seq force one thread there, main.c:211-215)
DBG_FLAGS = {
    "--print-qname": dbg.DBG_PRINT_QNAME,
    "--dbg-polish": dbg.DBG_PRINT_QNAME | dbg.DBG_POLISH,
    "--print-seeds": dbg.DBG_PRINT_QNAME | dbg.DBG_PRINT_SEED,
    "--print-aln-seq": dbg.DBG_PRINT_QNAME | dbg.DBG_PRINT_ALN_SEQ,
}


def _yes_no(s: str) -> bool:
    return s.lower() in ("yes", "y", "1", "true")


def _num(s: str) -> int:
    s = s.strip()
    mult = 1
    if s and s[-1] in "kKmMgG":
        mult = {"k": 10**3, "m": 10**6, "g": 10**9}[s[-1].lower()]
        s = s[:-1]
    return int(float(s) * mult)


def _not_ported(what: str) -> int:
    print(f"[ERROR] {what} is not yet ported to winnowmap_tpu_torch; use "
          "python -m winnowmap_tpu.cli", file=sys.stderr)
    return 2


def main(argv: list[str] | None = None, device=None) -> int:
    """The CLI; the debug dumps' flags hold for this call only."""
    try:
        return _main(argv, device)
    finally:
        dbg.flag = 0


def _main(argv, device) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(USAGE, file=sys.stderr)
        return 1
    io = IndexOptions()
    mo = MapOptions()

    # first pass: apply the preset (reference main.c:146-160)
    preset = None
    for i, a in enumerate(argv):
        if a == "-x" and i + 1 < len(argv):
            preset = argv[i + 1]
        elif a.startswith("-x") and len(a) > 2:
            preset = a[2:]
    if preset is not None:
        if preset not in PRESETS:
            return _not_ported(f"preset '{preset}'")
        set_preset(preset, io, mo)

    pos = []
    out_path = None
    rg = None
    w_file = None
    bloom_mode = False
    junc_bed = None
    idx_dump = None
    split_prefix = None
    i = 0

    def take():
        nonlocal i
        i += 1
        if i >= len(argv):
            raise SystemExit(f"[ERROR] missing argument for {argv[i-1]}")
        return argv[i]

    while i < len(argv):
        a = argv[i]
        if not a.startswith("-") or a == "-":
            pos.append(a)
        elif a in DBG_FLAGS:
            dbg.flag |= DBG_FLAGS[a]
        elif a == "-d":
            idx_dump = take()
        elif a == "-I":
            io.batch_size = _num(take())
        elif a == "--split-prefix":
            # reference --split-prefix (splitidx.c): where the per-part hit
            # files live; -I always merges them (map_file_multipart)
            split_prefix = take()
        elif a == "--frag":
            if _yes_no(take()):
                mo.flag |= MM_F_FRAG_MODE
            else:
                mo.flag &= ~MM_F_FRAG_MODE
        elif a == "-F":
            mo.max_frag_len = _num(take())
        elif a == "-x":
            i += 1  # handled in the first pass
        elif a.startswith("-x"):
            pass
        elif a == "--device":
            device = take()
        elif a == "-W":
            w_file = take()
        elif a == "--bloom-filter":
            bloom_mode = True
        elif a == "-T":
            mo.sdust_thres = int(take())
        elif a == "-k":
            io.k = int(take())
        elif a == "-w":
            io.w = int(take())
        elif a == "-H":
            io.flag |= 1
        elif a == "-t":
            # the engine's thread pool size (reference main.c:133)
            os.environ.setdefault("WM_ENGINE_THREADS",
                                  str(max(1, int(take()))))
        elif a == "-f":
            mo.mid_occ_frac = float(take().split(",")[0])
        elif a == "-g":
            mo.max_gap = _num(take())
        elif a == "-G":
            mo.max_gap_ref = mo.bw = _num(take())
        elif a == "-r":
            mo.bw = _num(take())
        elif a == "-n":
            mo.min_cnt = int(take())
        elif a == "-m":
            mo.min_chain_score = int(take())
        elif a == "-p":
            mo.pri_ratio = float(take())
        elif a == "-N":
            mo.best_n = int(take())
        elif a == "-P":
            mo.flag |= MM_F_ALL_CHAINS
        elif a == "-a":
            mo.flag |= MM_F_OUT_SAM | MM_F_CIGAR
        elif a == "-c":
            mo.flag |= MM_F_OUT_CG | MM_F_CIGAR
        elif a == "-o":
            out_path = take()
        elif a == "-A":
            mo.a = int(take())
        elif a == "-B":
            mo.b = int(take())
        elif a == "-O":
            v = take().split(",")
            mo.q = int(v[0])
            mo.q2 = int(v[1]) if len(v) > 1 else mo.q2
        elif a == "-E":
            v = take().split(",")
            mo.e = int(v[0])
            mo.e2 = int(v[1]) if len(v) > 1 else mo.e2
        elif a == "-z":
            v = take().split(",")
            mo.zdrop = _num(v[0])
            if len(v) > 1:
                mo.zdrop_inv = _num(v[1])
        elif a == "-s":
            mo.min_dp_max = _num(take())
        elif a == "-L":
            mo.flag |= MM_F_LONG_CIGAR
        elif a == "-R":
            rg = take()
        elif a == "-y":
            mo.flag |= MM_F_COPY_COMMENT
        elif a == "-Y":
            mo.flag |= MM_F_SOFTCLIP
        elif a == "-K":
            mo.mini_batch_size = _num(take())
        elif a == "--junc-bonus":
            mo.junc_bonus = int(take())
        elif a == "--junc-bed":
            junc_bed = take()
        elif a == "-X":
            mo.flag |= (MM_F_ALL_CHAINS | MM_F_NO_DIAG | MM_F_NO_DUAL
                        | MM_F_NO_LJOIN)
        elif a == "-D":
            mo.flag |= MM_F_NO_DIAG
        elif a == "--for-only":
            mo.flag |= MM_F_FOR_ONLY
        elif a == "--rev-only":
            mo.flag |= MM_F_REV_ONLY
        elif a == "--sr":
            mo.flag |= MM_F_SR
        elif a == "-u":
            take()
            warn("splice junction matching is handled by the splice preset")
        elif a == "--sv-off":
            mo.sv_aware = False
        elif a == "--cs" or a.startswith("--cs="):
            mo.flag |= MM_F_OUT_CS | MM_F_CIGAR
            if a.endswith("=long"):
                mo.flag |= MM_F_OUT_CS_LONG
        elif a == "--MD":
            mo.flag |= MM_F_OUT_MD | MM_F_CIGAR
        elif a == "--eqx":
            mo.flag |= MM_F_EQX
        elif a == "--secondary":
            if take() == "no":
                mo.flag |= MM_F_NO_PRINT_2ND
        elif a.startswith("--secondary="):
            if a.split("=", 1)[1] == "no":
                mo.flag |= MM_F_NO_PRINT_2ND
        elif a == "--paf-no-hit":
            mo.flag |= MM_F_PAF_NO_HIT
        elif a == "--sam-hit-only":
            mo.flag |= MM_F_SAM_HIT_ONLY
        elif a == "--hard-mask-level":
            mo.flag |= MM_F_HARD_MLEVEL
        elif a == "--mask-len":
            mo.mask_len = _num(take())
        elif a == "-M":
            mo.mask_level = float(take())
        elif a == "--min-occ-floor":
            mo.min_mid_occ = int(take())
        elif a == "--max-qlen":
            mo.max_qlen = _num(take())
        elif a == "--seed":
            mo.seed = int(take())
        elif a == "--no-end-flt":
            mo.flag |= MM_F_NO_END_FLT
        elif a == "--cap-sw-mem":
            mo.max_sw_mat = _num(take())
        elif a == "--version":
            print(__version__)
            return 0
        elif a in ("-h", "--help"):
            print(USAGE, file=sys.stderr)
            return 0
        else:
            print(f'[ERROR] unknown option in "{a}"', file=sys.stderr)
            return 1
        i += 1

    if not pos:
        print(USAGE, file=sys.stderr)
        return 1
    check_options(io, mo)

    phase_log("main", "reading downweighted kmers")
    if bloom_mode:
        bloom = load_weight_bloom(w_file, io.k)
        wset = np.zeros(0, np.uint64)
    else:
        bloom = None
        wset = load_weight_set(w_file, io.k)
        phase_log("main", "collected downweighted kmers, no. of kmers "
                          f"read={len(wset)}")
    target, queries = pos[0], pos[1:]
    frag_mode = len(queries) > 1 or bool(mo.flag & MM_F_FRAG_MODE)
    if queries and frag_mode and (mo.flag & MM_F_SPLICE):
        raise SystemExit("[ERROR] --splice and --frag should not be "
                         "specified at the same time.")
    records = parts_meta = None
    if is_mmi_file(target):
        # the reference's prebuilt index (MMI\2, src/index.c:556-608)
        # stores no weight set, so queries sketch unweighted, as the
        # reference's do with a loaded index (mm_idx_load never restores
        # the filter)
        mi = load_mmi(target)
        if w_file:
            warn("prebuilt MMI index: -W list ignored (reference "
                 "behaviour)")
    elif is_index_file(target):
        mi = load_index(target)
        if w_file and len(wset) and len(mi.wset) != len(wset):
            warn("prebuilt index: -W list ignored (stored set used)")
    else:
        records = read_all(target)
        total_bp = sum(len(r.seq) for r in records)
        if queries and io.batch_size and total_bp > io.batch_size \
                and not idx_dump:
            # -I: the parts are built one at a time by map_file_multipart;
            # the whole index is not built (the JAX CLI builds it too, for
            # its log line, with no change to the output)
            parts_meta = [[(r.name, len(r.seq)) for r in records]]
            mi = merged_meta_index(parts_meta, io)
        else:
            mi = build_index(records, io.w, io.k, io.flag, wset,
                             bool(io.flag & 1), weight_bloom=bloom,
                             device=device)
    if parts_meta is None:
        phase_log("index", mi.stat_line())
        update_mid_occ(mo, mi)
    if junc_bed:
        read_bed(mi, junc_bed, read_junc=True)
    if idx_dump:
        if idx_dump.endswith(".mmi"):
            # the reference's format, which the stock winnowmap loads
            # (reference mm_idx_dump, src/index.c:515-554)
            dump_mmi(mi, idx_dump)
        else:
            dump_index(mi, idx_dump)
        phase_log("index", f"index dumped to {idx_dump}")
    if not queries:
        if not idx_dump:
            warn("no query file given; index built only (use -d to save "
                 "it)")
        return 0

    out = open(out_path, "w") if out_path else sys.stdout
    try:
        if mo.flag & MM_F_OUT_SAM:
            cl = "winnowmap-tpu " + " ".join(argv)
            print(sam_header(mi, rg, __version__, cl), file=out)
        if (records is not None and io.batch_size
                and sum(s_.length for s_ in mi.seqs) > io.batch_size):
            tdir = None
            if split_prefix:
                tdir = str(Path(split_prefix).resolve().parent)
                os.makedirs(tdir, exist_ok=True)
            map_file_multipart(records, io, mo, wset, queries, out=out,
                               batch_bp=io.batch_size, device=device,
                               tmp_dir=tdir)
        elif frag_mode:
            map_file_frag(mi, mo, queries, out=out, device=device)
        else:
            for qf in queries:
                map_file(mi, mo, qf, out=out, device=device)
    finally:
        if out is not sys.stdout:
            out.close()
    phase_log("main", f"Version: {__version__}; CMD: winnowmap-tpu "
                      f"{' '.join(argv)}")
    phase_log("main", f"Real time: {realtime():.3f} sec; CPU: "
                      f"{cputime():.3f} sec; Peak RSS: {peakrss():.3f} GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
