"""Scoring matrix for the extension DP (reference ksw_gen_simple_mat,
src/align.c:9-22)."""
from __future__ import annotations

import numpy as np

_MAT_CACHE: dict = {}


def gen_simple_mat(a: int, b: int, sc_ambi: int) -> np.ndarray:
    """5x5 match/mismatch matrix, memoized per (a, b, sc_ambi); read-only."""
    key = (a, b, sc_ambi)
    cached = _MAT_CACHE.get(key)
    if cached is not None:
        return cached
    a = abs(a)
    b = -abs(b)
    sc_ambi = -abs(sc_ambi)
    mat = np.zeros(25, dtype=np.int8)
    for i in range(4):
        for j in range(4):
            mat[i * 5 + j] = a if i == j else b
        mat[i * 5 + 4] = sc_ambi
    for j in range(5):
        mat[20 + j] = sc_ambi
    mat.setflags(write=False)
    _MAT_CACHE[key] = mat
    return mat
