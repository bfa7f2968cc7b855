"""Carry the JAX package's state across: its index, handed over as plain
numpy arrays and scalars, becomes the port's MinimizerIndex.

The minimizer index is this system's counterpart of a model's weights: the
JAX package builds it (winnowmap_tpu.index.build.MinimizerIndex) and the
port maps against the same arrays.  The caller turns the JAX object into a
dict of numpy arrays and plain values; this module never imports the JAX
package.
"""
from __future__ import annotations

import numpy as np

from .index.build import MinimizerIndex, SeqMeta


def index_from_arrays(d: dict) -> MinimizerIndex:
    """Build the port's index from a dict with keys

      keys (uint64), start (int64), pos (uint64), codes (uint8),
      seq_names (list of str), seq_offsets, seq_lengths (int64),
      wset (uint64), bloom (None or (table u8, bits, salt0, salt1)),
      w, k, flag (int).

    Arrays are copied into contiguous arrays of the index's dtypes."""
    names = list(d["seq_names"])
    offs = np.asarray(d["seq_offsets"], np.int64)
    lens = np.asarray(d["seq_lengths"], np.int64)
    if not (len(names) == len(offs) == len(lens)):
        raise ValueError("seq_names, seq_offsets and seq_lengths differ in "
                         "length")
    keys = np.ascontiguousarray(d["keys"], np.uint64)
    start = np.ascontiguousarray(d["start"], np.int64)
    if len(start) != len(keys) + 1:
        raise ValueError("start must have len(keys) + 1 entries")
    bloom = d.get("bloom")
    if bloom is not None:
        table, bits, s0, s1 = bloom
        bloom = (np.ascontiguousarray(table, np.uint8), int(bits), int(s0),
                 int(s1))
    return MinimizerIndex(
        w=int(d["w"]), k=int(d["k"]), flag=int(d["flag"]),
        seqs=[SeqMeta(str(n), int(o), int(ln))
              for n, o, ln in zip(names, offs, lens)],
        keys=keys, start=start,
        pos=np.ascontiguousarray(d["pos"], np.uint64),
        codes=np.ascontiguousarray(d["codes"], np.uint8),
        wset=np.ascontiguousarray(d.get("wset", np.zeros(0)), np.uint64),
        bloom=bloom)
