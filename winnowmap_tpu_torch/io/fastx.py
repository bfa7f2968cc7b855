"""Batched FASTA/FASTQ input (reference parity: src/bseq.c + src/kseq.h).

Reads gzipped or plain FASTX through the native reader and exposes
batches of records with zero-copy numpy slicing.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from .. import native


@dataclass
class SeqRecord:
    name: str
    seq: bytes
    qual: bytes | None
    comment: str | None
    rid: int = -1


class FastxReader:
    """Iterate batches of records, each batch up to ~max_bp bases
    (reference mm_bseq_read3 batching, src/bseq.c:80-129)."""

    def __init__(self, path: str):
        self._L = native.lib()
        self._h = self._L.wm_fastx_open(path.encode())
        if not self._h:
            raise FileNotFoundError(path)

    def close(self):
        if self._h:
            self._L.wm_fastx_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def read_batch(self, max_bp: int = 50_000_000) -> list[SeqRecord] | None:
        L = self._L
        b = L.wm_fastx_read_batch(self._h, max_bp)
        if not b:
            return None
        try:
            n = L.wm_batch_n(b)
            soff = np.ctypeslib.as_array(L.wm_batch_seq_off(b), (n + 1,))
            noff = np.ctypeslib.as_array(L.wm_batch_name_off(b), (n + 1,))
            qoff = np.ctypeslib.as_array(L.wm_batch_qual_off(b), (n + 1,))
            coff = np.ctypeslib.as_array(L.wm_batch_comment_off(b), (n + 1,))
            seqs = ctypes.string_at(L.wm_batch_seqs(b), soff[n]) if soff[n] else b""
            names = ctypes.string_at(L.wm_batch_names(b), noff[n]) if noff[n] else b""
            quals = ctypes.string_at(L.wm_batch_quals(b), qoff[n]) if qoff[n] else b""
            comments = (
                ctypes.string_at(L.wm_batch_comments(b), coff[n]) if coff[n] else b""
            )
            out = []
            for i in range(n):
                q = quals[qoff[i]:qoff[i + 1]]
                c = comments[coff[i]:coff[i + 1]]
                out.append(
                    SeqRecord(
                        name=names[noff[i]:noff[i + 1]].decode(),
                        seq=seqs[soff[i]:soff[i + 1]],
                        qual=q if q else None,
                        comment=c.decode() if c else None,
                    )
                )
            return out
        finally:
            L.wm_batch_free(b)

    def __iter__(self):
        while True:
            b = self.read_batch()
            if b is None:
                return
            yield b


def read_all(path: str) -> list[SeqRecord]:
    with FastxReader(path) as r:
        out = []
        for batch in r:
            out.extend(batch)
        for i, rec in enumerate(out):
            rec.rid = i
        return out
