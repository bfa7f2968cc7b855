"""winnowmap-compatible command line for the PyTorch/CUDA port (reference
src/main.c).

    python -m winnowmap_tpu_torch.cli [-x map-ont|map-pb|asm5|asm10|asm20|
        splice|splice:hq|cdna] [-a|-c] [--sv-off] [--device cuda|cpu]
        -W rep.txt ref.fa reads.fa

Maps reads against a reference built on the fly and writes PAF or SAM, with
the same flags and output as winnowmap_tpu.cli.  Single-cost gap profiles
(-O q,q -E e,e) run the extz kernel, spliced presets exts, the others extd.
The DP runs on the CUDA card; --device cpu runs the kernels' plain PyTorch
versions.  Flags of paths not ported yet exit with a "not yet ported"
error.
"""
from __future__ import annotations

import os
import sys

import numpy as np

from . import __version__
from .index.build import build_index, load_weight_bloom, load_weight_set
from .io.fastx import read_all
from .io.sam import sam_header
from .map.pipeline import map_file
from .options import (
    MM_F_ALL_CHAINS,
    MM_F_CIGAR,
    MM_F_COPY_COMMENT,
    MM_F_EQX,
    MM_F_HARD_MLEVEL,
    MM_F_LONG_CIGAR,
    MM_F_NO_PRINT_2ND,
    MM_F_OUT_CG,
    MM_F_OUT_CS,
    MM_F_OUT_CS_LONG,
    MM_F_OUT_MD,
    MM_F_OUT_SAM,
    MM_F_PAF_NO_HIT,
    MM_F_SAM_HIT_ONLY,
    MM_F_SOFTCLIP,
    IndexOptions,
    MapOptions,
    check_options,
    set_preset,
    update_mid_occ,
)
from .utils.log import cputime, peakrss, phase_log, realtime, warn

USAGE = """Usage: python -m winnowmap_tpu_torch.cli [options] <target.fa> <query.fa>
The PyTorch/CUDA port of winnowmap-tpu (Winnowmap v2.03 capabilities);
flags mirror the reference (see winnowmap --help)."""

PRESETS = ("map-ont", "map-pb", "map-pb-clr", "asm5", "asm10", "asm20",
           "splice", "splice:hq", "cdna")

# flags of paths that are not in this slice of the port
NOT_PORTED = {
    "-d": "index dump", "-I": "multi-part indexes", "--split-prefix":
    "multi-part indexes", "--junc-bed": "splice junctions from a BED file",
    "--sr": "short reads",
    "--frag": "paired-end / fragment mode", "-F": "paired-end / fragment "
    "mode", "-X": "all-chains mode", "-D": "no-diagonal mode",
    "--for-only": "single-strand mode", "--rev-only": "single-strand mode",
    "--print-qname": "debug dumps", "--dbg-polish": "debug dumps",
    "--print-seeds": "debug dumps", "--print-aln-seq": "debug dumps",
}


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
        elif a in NOT_PORTED or a.startswith("--frag="):
            return _not_ported(NOT_PORTED.get(a, "fragment mode"))
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

    if len(pos) < 2:
        if len(pos) == 1:
            return _not_ported("building an index without mapping (-d)")
        print(USAGE, file=sys.stderr)
        return 1
    if len(pos) > 2:
        return _not_ported("mapping several query files (fragment mode)")
    target, query = pos
    with open(target, "rb") as f:
        head = f.read(6)
    if head.startswith(b"MMI\x02") or head == b"WMTI1\x00":
        return _not_ported("loading a prebuilt index")
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
    mi = build_index(read_all(target), io.w, io.k, io.flag, wset,
                     bool(io.flag & 1), weight_bloom=bloom)
    phase_log("index", mi.stat_line())
    update_mid_occ(mo, mi)

    out = open(out_path, "w") if out_path else sys.stdout
    try:
        if mo.flag & MM_F_OUT_SAM:
            cl = "winnowmap-tpu " + " ".join(argv)
            print(sam_header(mi, rg, __version__, cl), file=out)
        map_file(mi, mo, query, out=out, device=device)
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
