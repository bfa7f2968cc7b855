"""Per-read mapping result and the read-name hash the engine seeds with
(reference mm_map_frag, src/map.c:279-981; the orchestration itself runs in
the native engine)."""
from __future__ import annotations

from dataclasses import dataclass

U32MASK = 0xFFFFFFFF


def _x31_hash(s: str) -> int:
    h = 0
    for ch in s.encode():
        h = ((h << 5) - h + ch) & U32MASK
    return h


@dataclass
class MapResult:
    regs: list
    rep_len: int
    frag_gap: int
    # False when the reference leaves rep_len uninitialized on this path
    # (MCAS success with full read coverage, reference map.c:281 vs 917:
    # outer rep_len is never written before use -- a reference UB we resolve
    # to 0).  Tests treat rl/MAPQ as unspecified for such reads.
    rep_len_defined: bool = True
