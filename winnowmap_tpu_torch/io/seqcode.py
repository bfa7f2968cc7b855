"""Sequence byte <-> 2-bit/4-value code tables (reference sketch.c:19-36)."""
from __future__ import annotations

import numpy as np

NT4 = np.full(256, 4, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    NT4[_b] = _c
for _b, _c in zip(b"acgt", range(4)):
    NT4[_b] = _c
NT4[ord("U")] = NT4[ord("u")] = 3

CODE2CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)

# full IUPAC complement (reference bseq.c:11-28 seq_comp_table)
COMP = np.arange(256, dtype=np.uint8)
for _a, _b in [
    (b"A", b"T"), (b"C", b"G"), (b"G", b"C"), (b"T", b"A"), (b"U", b"A"),
    (b"R", b"Y"), (b"Y", b"R"), (b"S", b"S"), (b"W", b"W"), (b"K", b"M"),
    (b"M", b"K"), (b"B", b"V"), (b"V", b"B"), (b"D", b"H"), (b"H", b"D"),
    (b"N", b"N"),
]:
    COMP[_a[0]] = _b[0]
    COMP[_a[0] | 0x20] = _b[0] | 0x20


def encode(seq: bytes) -> np.ndarray:
    """ASCII -> 0..4 codes."""
    return NT4[np.frombuffer(seq, dtype=np.uint8)]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement on 0..4 codes (4 stays 4)."""
    out = codes[::-1].copy()
    m = out < 4
    out[m] = 3 - out[m]
    return out


def revcomp_bytes(seq: bytes) -> bytes:
    return COMP[np.frombuffer(seq, dtype=np.uint8)][::-1].tobytes()
