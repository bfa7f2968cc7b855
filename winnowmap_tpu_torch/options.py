"""Option / preset system for winnowmap-tpu.

Capability parity with the reference option system
(reference src/options.c:5-188, src/minimap.h:106-183):
compiled defaults -> preset -> user flags -> validation -> index-dependent
derivation of mid_occ.  Field names follow the reference so that flags map 1:1.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

# ---- mapping-time flags (reference minimap.h:22-52) ----
MM_F_NO_DIAG = 0x001
MM_F_NO_DUAL = 0x002
MM_F_CIGAR = 0x004
MM_F_OUT_SAM = 0x008
MM_F_NO_QUAL = 0x010
MM_F_OUT_CG = 0x020
MM_F_OUT_CS = 0x040
MM_F_SPLICE = 0x080
MM_F_SPLICE_FOR = 0x100
MM_F_SPLICE_REV = 0x200
MM_F_NO_LJOIN = 0x400
MM_F_OUT_CS_LONG = 0x800
MM_F_SR = 0x1000
MM_F_FRAG_MODE = 0x2000
MM_F_NO_PRINT_2ND = 0x4000
MM_F_2_IO_THREADS = 0x8000
MM_F_LONG_CIGAR = 0x10000
MM_F_INDEPEND_SEG = 0x20000
MM_F_SPLICE_FLANK = 0x40000
MM_F_SOFTCLIP = 0x80000
MM_F_FOR_ONLY = 0x100000
MM_F_REV_ONLY = 0x200000
MM_F_HEAP_SORT = 0x400000
MM_F_ALL_CHAINS = 0x800000
MM_F_OUT_MD = 0x1000000
MM_F_COPY_COMMENT = 0x2000000
MM_F_EQX = 0x4000000
MM_F_PAF_NO_HIT = 0x8000000
MM_F_NO_END_FLT = 0x10000000
MM_F_HARD_MLEVEL = 0x20000000
MM_F_SAM_HIT_ONLY = 0x40000000

# ---- index flags (reference minimap.h:17-20) ----
MM_I_HPC = 0x1
MM_I_NO_SEQ = 0x2
MM_I_NO_NAME = 0x4

# ---- seed annotation bits on anchor.y (reference mmpriv.h:17-23) ----
MM_SEED_LONG_JOIN = 1 << 40
MM_SEED_IGNORE = 1 << 41
MM_SEED_TANDEM = 1 << 42
MM_SEED_SELF = 1 << 43
MM_SEED_SEG_SHIFT = 48
MM_SEED_SEG_MASK = 0xFF << MM_SEED_SEG_SHIFT

MM_MAX_SEG = 255


@dataclass
class IndexOptions:
    """Reference mm_idxopt_t (minimap.h:106-112), defaults options.c:5-12."""

    k: int = 15
    w: int = 50
    flag: int = 0
    bucket_bits: int = 14
    mini_batch_size: int = 50_000_000
    batch_size: int = 4_000_000_000


@dataclass
class MapOptions:
    """Reference mm_mapopt_t (minimap.h:114-183), defaults options.c:14-69."""

    flag: int = 0
    seed: int = 11
    sdust_thres: int = 0

    max_qlen: int = 0

    bw: int = 500
    max_gap: int = 5000
    min_gap_ref: int = 1000
    max_gap_ref: int = -1
    max_frag_len: int = 0
    max_chain_skip: int = 25
    max_chain_iter: int = 5000
    min_cnt: int = 3
    min_chain_score: int = 40
    chain_gap_scale: float = 1.0

    mask_level: float = 0.5
    mask_len: int = 2**31 - 1
    pri_ratio: float = 0.8
    best_n: int = 5

    max_join_long: int = 20000
    max_join_short: int = 2000
    min_join_flank_sc: int = 1000
    min_join_flank_ratio: float = 0.5

    alt_drop: float = 0.0

    a: int = 2  # match score
    b: int = 4  # mismatch penalty
    q: int = 4  # gap open
    e: int = 2  # gap extension
    q2: int = 24  # long gap open
    e2: int = 1  # long gap extension
    sc_ambi: int = 1
    noncan: int = 0
    junc_bonus: int = 0
    zdrop: int = 400
    zdrop_inv: int = 200
    end_bonus: int = -1
    min_dp_max: int = 80  # min_chain_score * a
    min_ksw_len: int = 200
    anchor_ext_len: int = 20
    anchor_ext_shift: int = 6
    max_clip_ratio: float = 1.0

    pe_ori: int = 0
    pe_bonus: int = 33

    mid_occ_frac: float = -1.0
    min_mid_occ: int = 0
    mid_occ: int = 5000
    max_occ: int = 0
    mini_batch_size: int = 1_000_000_000
    max_sw_mat: int = 0  # minimap.h:172 cap_sw_mem; 0 = unlimited

    split_prefix: str | None = None

    # SV-aware (Winnowmap2) MCAS parameters (options.c:55-68)
    max_prefix_length: int = 16000
    min_prefix_length: int = 2000
    suffix_sample_offset: int = 2000
    prefix_increment_factor: float = field(
        default_factory=lambda: math.pow((16000 - 1) * 1.0 / 2000, 0.5)
    )
    min_mapq: int = 5
    min_qcov: float = 0.5
    sv_aware: bool = True
    sv_aware_min_read_length: int = 10000

    stage2_zdrop_inv: int = 25
    stage2_bw: int = 2000
    stage2_max_gap: int = 16000
    stage2_extension_inc: int = 1


PRESETS = (
    "map-ont",
    "map-pb",
    "map-pb-clr",
    "asm5",
    "asm10",
    "asm20",
    "splice",
    "splice:hq",
    "cdna",
)


def set_preset(preset: str | None, io: IndexOptions, mo: MapOptions) -> None:
    """Apply a preset in place (reference mm_set_opt, options.c:89-131)."""
    if preset is None:
        return
    if preset == "map-ont":
        io.flag, io.k = 0, 15
    elif preset == "map-pb":
        io.flag, io.k = 0, 15
        mo.max_prefix_length = mo.stage2_max_gap = 8000
        mo.suffix_sample_offset = mo.min_prefix_length = 1000
        mo.stage2_bw = 1000
        mo.prefix_increment_factor = math.pow(
            (mo.max_prefix_length - 1) * 1.0 / mo.min_prefix_length, 0.33
        )
    elif preset == "map-pb-clr":
        mo.sv_aware = False
    elif preset == "asm5":
        io.flag, io.k = 0, 19
        mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 19, 39, 81, 3, 1
        mo.zdrop = mo.zdrop_inv = 200
        mo.min_dp_max = 200
    elif preset == "asm10":
        io.flag, io.k = 0, 19
        mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 9, 16, 41, 2, 1
        mo.zdrop = mo.zdrop_inv = 200
        mo.min_dp_max = 200
    elif preset == "asm20":
        io.flag, io.k = 0, 19
        mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 4, 6, 26, 2, 1
        mo.zdrop = mo.zdrop_inv = 200
        mo.min_dp_max = 200
    elif preset.startswith("splice") or preset == "cdna":
        mo.sv_aware = False
        io.w = 25
        io.flag, io.k = 0, 15
        mo.flag |= MM_F_SPLICE | MM_F_SPLICE_FOR | MM_F_SPLICE_REV | MM_F_SPLICE_FLANK
        mo.max_gap = 2000
        mo.max_gap_ref = mo.bw = 200000
        mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 1, 2, 2, 1, 32, 0
        mo.noncan = 9
        mo.junc_bonus = 9
        mo.zdrop, mo.zdrop_inv = 200, 100
        if preset == "splice:hq":
            mo.junc_bonus, mo.b, mo.q, mo.q2 = 5, 4, 6, 24
    else:
        raise ValueError(f"unknown preset: {preset!r}")


def update_mid_occ(mo: MapOptions, index) -> None:
    """Derive mid_occ from the index occurrence distribution
    (reference mm_mapopt_update, options.c:71-81)."""
    if (mo.flag & MM_F_SPLICE_FOR) or (mo.flag & MM_F_SPLICE_REV):
        mo.flag |= MM_F_SPLICE
    if 0 <= mo.mid_occ_frac < 1:
        mo.mid_occ = index.cal_max_occ(mo.mid_occ_frac)
    if mo.mid_occ < mo.min_mid_occ:
        mo.mid_occ = mo.min_mid_occ


def check_options(io: IndexOptions, mo: MapOptions) -> None:
    """Validate (reference mm_check_opt, options.c:133-188); raises ValueError."""
    if mo.split_prefix and (mo.flag & (MM_F_OUT_CS | MM_F_OUT_MD)):
        raise ValueError("--cs or --MD doesn't work with --split-prefix")
    if io.k <= 0 or io.w <= 0:
        raise ValueError("-k and -w must be positive")
    if mo.best_n < 0:
        raise ValueError("-N must be no less than 0")
    if not (0.0 <= mo.pri_ratio <= 1.0):
        raise ValueError("-p must be within 0 and 1 (including 0 and 1)")
    if (mo.flag & MM_F_FOR_ONLY) and (mo.flag & MM_F_REV_ONLY):
        raise ValueError("--for-only and --rev-only can't be applied at the same time")
    if mo.e <= 0 or mo.q <= 0:
        raise ValueError("-O and -E must be positive")
    if (mo.q != mo.q2 or mo.e != mo.e2) and not (mo.e > mo.e2 and mo.q + mo.e < mo.q2 + mo.e2):
        raise ValueError("dual gap penalties violating E1>E2 and O1+E1<O2+E2")
    if (mo.q + mo.e) + (mo.q2 + mo.e2) > 127:
        raise ValueError("scoring system violating ({-O}+{-E})+({-O2}+{-E2}) <= 127")
    if mo.zdrop < mo.zdrop_inv:
        raise ValueError("Z-drop should not be less than inversion-Z-drop")
    if (mo.flag & MM_F_NO_PRINT_2ND) and (mo.flag & MM_F_ALL_CHAINS):
        raise ValueError("-X/-P and --secondary=no can't be applied at the same time")


def stage1_options(mo: MapOptions) -> MapOptions:
    """Stage-1 (MCAS) option override (reference map.c:300-302)."""
    return replace(mo, best_n=max(5, mo.best_n))


def stage2_options(mo: MapOptions) -> MapOptions:
    """Stage-2 option override (reference map.c:711-717)."""
    return replace(
        mo,
        zdrop_inv=min(mo.zdrop_inv, mo.stage2_zdrop_inv),
        bw=max(mo.bw, mo.stage2_bw),
        max_gap=max(mo.max_gap, mo.stage2_max_gap),
    )
