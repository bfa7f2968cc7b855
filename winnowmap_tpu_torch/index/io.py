"""Binary index serialization (reference mm_idx_dump/mm_idx_load,
src/index.c:515-608: the MMI\\2 container), in the JAX package's WMTI1
format, byte for byte.

The WMTI1 container serializes the flat sorted-array index directly --
keys / run starts / occurrence records / reference codes / exact
down-weight set / bloom table -- so loading is a handful of bulk reads with
no rebuild step, the reference's "pay the indexing cost once" workflow
(reference main.c:384-424).  The index stays on the host; a loaded index's
codes go to the card when a batch maps against it
(extend/kernels.PoolContext)."""
from __future__ import annotations

import struct

import numpy as np

from .build import MinimizerIndex, SeqMeta

MAGIC = b"WMTI1\x00"


def _write_arr(f, a: np.ndarray) -> None:
    f.write(struct.pack("<cQ", a.dtype.char.encode(), a.size))
    f.write(a.tobytes())


def _read_arr(f) -> np.ndarray:
    ch, n = struct.unpack("<cQ", f.read(9))
    dt = np.dtype(ch.decode())
    return np.frombuffer(f.read(int(n) * dt.itemsize), dtype=dt).copy()


def dump_index(mi: MinimizerIndex, path: str) -> None:
    """Write the index to `path` (reference mm_idx_dump, index.c:515-554)."""
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<iiii", mi.w, mi.k, mi.flag, mi.n_seq))
        for s in mi.seqs:
            name = s.name.encode()
            f.write(struct.pack("<iqq", len(name), s.offset, s.length))
            f.write(name)
        _write_arr(f, mi.keys)
        _write_arr(f, mi.start)
        _write_arr(f, mi.pos)
        _write_arr(f, mi.codes)
        _write_arr(f, mi.wset)
        if mi.bloom is not None:
            table, bits, s0, s1 = mi.bloom
            f.write(struct.pack("<B", 1))
            f.write(struct.pack("<QII", bits, s0, s1))
            _write_arr(f, np.ascontiguousarray(table, np.uint8))
        else:
            f.write(struct.pack("<B", 0))


def load_index(path: str) -> MinimizerIndex:
    """Read an index written by dump_index (reference mm_idx_load,
    index.c:556-608)."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a winnowmap-tpu index")
        w, k, flag, n_seq = struct.unpack("<iiii", f.read(16))
        mi = MinimizerIndex(w=w, k=k, flag=flag)
        for _ in range(n_seq):
            ln, off, length = struct.unpack("<iqq", f.read(20))
            name = f.read(ln).decode()
            mi.seqs.append(SeqMeta(name, off, length))
        mi.keys = _read_arr(f)
        mi.start = _read_arr(f)
        mi.pos = _read_arr(f)
        mi.codes = _read_arr(f)
        mi.wset = _read_arr(f)
        tag = f.read(1)
        if tag == b"\x01":
            bits, s0, s1 = struct.unpack("<QII", f.read(16))
            table = _read_arr(f)
            mi.bloom = (table, bits, s0, s1)
    return mi


def is_index_file(path: str) -> bool:
    """Auto-detect index vs FASTA input (reference mm_idx_is_idx,
    src/index.c:610-633)."""
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC)) == MAGIC
    except OSError:
        return False
