"""Alignment records (reference mm_reg1_t / mm_extra_t, src/minimap.h:79-103).

The port only needs the record types: region generation, parent assignment,
secondary selection and the MAPQ model run inside the native engine
(native/src/wm_engine.cpp), and the SAM/PAF writers read these fields.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MM_PARENT_UNSET = -1
MM_PARENT_TMP_PRI = -2


@dataclass
class Extra:
    """Alignment detail (reference mm_extra_t, minimap.h:79-86)."""

    dp_score: int = 0
    dp_max: int = 0
    dp_max2: int = 0
    n_ambi: int = 0
    trans_strand: int = 0
    cigar: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))


@dataclass
class Reg:
    """One alignment region (reference mm_reg1_t, minimap.h:88-103)."""

    id: int = 0
    cnt: int = 0
    rid: int = 0
    score: int = 0
    qs: int = 0
    qe: int = 0
    rs: int = 0
    re: int = 0
    parent: int = MM_PARENT_UNSET
    subsc: int = 0
    as_: int = 0
    mlen: int = 0
    blen: int = 0
    n_sub: int = 0
    score0: int = 0
    mapq: int = 0
    div: float = -1.0
    inv: bool = False
    rev: bool = False
    split: int = 0
    split_inv: bool = False
    sam_pri: bool = False
    proper_frag: bool = False
    pe_thru: bool = False
    seg_split: bool = False
    seg_id: int = 0
    n_segs: int = 1
    is_alt: bool = False
    hash: int = 0
    p: Extra | None = None
