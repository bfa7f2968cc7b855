"""Native meryl v1 database container (64+64 files + master index).

Reads and writes the reference meryl's on-disk DB format so this
framework's k-mer tooling interoperates with real meryl databases in both
directions (reference ext/meryl/src/utility/src/kmers-v1/kmers-writer.C,
kmers-files.C, kmers-reader.C; bit container
ext/meryl/src/utility/src/bits/stuffedBits-v1.H).

Layout: `merylIndex` master (magic "merylInd""ex__v.03", prefixSize,
suffixSize, numFilesBits, numBlocksBits, flags, histogram stats), then
2^numFilesBits pairs `0x<file-bits-in-binary>.merylData` /
`.merylIndex`.  Data files hold one stuffedBits dump per block prefix
(Elias-Fano suffixes + binary values, decoded/encoded by the native
codec, `native/src/wm_meryl.cpp`); index files are raw arrays of
(blockPrefix u64, filePosition u64, nKmers u64) per block.

The k-mer block distribution: file = prefix >> numBlocksBits, block =
prefix & (numBlocks-1), prefix = top `prefixSize` bits of the 2k-bit
canonical k-mer code (reference merylFileWriter::fileNumber,
kmers-writer.C:156-179).

A copy of winnowmap_tpu/kcount/meryldb.py on the port's native library,
so a database either package writes, the other reads.
"""
from __future__ import annotations

import os

import numpy as np

_M1_IDX = 0x646E496C7972656D  # "merylInd" little-endian
_M2_IDX = 0x33302E765F5F7865  # "ex__v.03"


class _BitReader:
    """stuffedBits dump reader (MSB-first bits over LE u64 words; values
    never span the container's internal blocks)."""

    def __init__(self, buf: bytes):
        self.buf = buf
        maxbits = int.from_bytes(buf[0:8], "little")
        n_blocks = int.from_bytes(buf[8:12], "little")
        del maxbits
        p = 16 + 8 * n_blocks  # skip bgn[]
        self.lens = [
            int.from_bytes(buf[p + 8 * i:p + 8 * i + 8], "little")
            for i in range(n_blocks)
        ]
        p += 8 * n_blocks
        self.words = []
        for ln in self.lens:
            nw = (ln + 63) // 64
            self.words.append(
                np.frombuffer(buf, np.uint64, nw, p).astype(object))
            p += 8 * nw
        self.end = p
        self.blk = 0
        self.pos = 0

    def get(self, width: int) -> int:
        if width == 0:
            return 0
        if self.pos + width > self.lens[self.blk]:
            assert self.pos == self.lens[self.blk], "read spans blocks"
            self.blk += 1
            self.pos = 0
        v = 0
        need = width
        while need:
            wrd, bit = self.pos >> 6, 64 - (self.pos & 63)
            take = min(need, bit)
            w = int(self.words[self.blk][wrd])
            v = (v << take) | ((w >> (bit - take)) & ((1 << take) - 1))
            self.pos += take
            need -= take
        return v


class _BitWriter:
    """stuffedBits dump writer mirroring the block-splitting semantics."""

    def __init__(self, max_bits: int):
        self.max_bits = max_bits
        self.blocks: list[tuple[bytearray, int]] = []
        self.cur = bytearray(max_bits // 8)
        self.pos = 0

    def _close(self):
        self.blocks.append((self.cur, self.pos))
        self.cur = bytearray(self.max_bits // 8)
        self.pos = 0

    def put(self, width: int, value: int):
        if width == 0:
            return
        if self.pos + width > self.max_bits:
            self._close()
        value &= (1 << width) - 1
        need = width
        while need:
            wrd, bit = self.pos >> 6, 64 - (self.pos & 63)
            take = min(need, bit)
            part = (value >> (need - take)) & ((1 << take) - 1)
            old = int.from_bytes(self.cur[wrd * 8:wrd * 8 + 8], "little")
            old |= part << (bit - take)
            self.cur[wrd * 8:wrd * 8 + 8] = old.to_bytes(8, "little")
            self.pos += take
            need -= take

    def dump(self) -> bytes:
        blocks = self.blocks + ([(self.cur, self.pos)]
                                if self.pos > 0 or not self.blocks else [])
        n = len(blocks)
        out = bytearray()
        out += self.max_bits.to_bytes(8, "little")
        out += n.to_bytes(4, "little")
        out += (((n + 31) // 32) * 32).to_bytes(4, "little")
        bgn = 0
        for _, ln in blocks:
            out += bgn.to_bytes(8, "little")
            bgn += ln
        for _, ln in blocks:
            out += ln.to_bytes(8, "little")
        for dat, ln in blocks:
            out += dat[: 8 * ((ln + 63) // 64)]
        return bytes(out)


def _block_name(db: str, file_idx: int, num_files_bits: int,
                is_index: bool) -> str:
    # files are named by the file number in BINARY with an 0x prefix
    # (reference constructBlockName, kmers-files.C via files.H)
    bits = format(file_idx, f"0{max(num_files_bits, 1)}b")
    ext = "merylIndex" if is_index else "merylData"
    return os.path.join(db, f"0x{bits}.{ext}")


def is_meryl_db(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "merylIndex"))


def read_meryl_db(path: str):
    """Read a meryl v1 database -> (k, kmers u64 asc, counts i64)."""
    from .. import native

    with open(os.path.join(path, "merylIndex"), "rb") as f:
        br = _BitReader(f.read())
    if br.get(64) != _M1_IDX or br.get(64) != _M2_IDX:
        raise ValueError(f"{path}: not a meryl database (bad magic)")
    prefix_size = br.get(32)
    suffix_size = br.get(32)
    num_files_bits = br.get(32)
    br.get(32)  # numBlocksBits
    br.get(32)  # flags
    k = (prefix_size + suffix_size) // 2
    if k > 32:
        raise ValueError(f"{path}: k={k} > 32 unsupported")
    kparts, vparts = [], []
    for fi in range(1 << num_files_bits):
        name = _block_name(path, fi, num_files_bits, is_index=False)
        if not os.path.exists(name):
            continue
        with open(name, "rb") as f:
            buf = f.read()
        if not buf:
            continue
        kk, vv = native.meryl_decode_data(buf, suffix_size)
        kparts.append(kk)
        vparts.append(vv)
    kmers = (np.concatenate(kparts) if kparts else np.zeros(0, np.uint64))
    vals = (np.concatenate(vparts) if vparts else np.zeros(0, np.uint64))
    return k, kmers, vals.astype(np.int64)


def write_meryl_db(path: str, k: int, kmers: np.ndarray, counts: np.ndarray,
                   prefix_size: int | None = None) -> None:
    """Write a meryl v1 database readable by the reference meryl tools.

    prefix_size defaults to the streaming writer's rule (12, clamped so
    numBlocksBits >= 0 and suffixSize >= 1; reference
    merylFileWriter::initialize, kmers-writer.C:25-82)."""
    from .. import native

    if prefix_size is None:
        prefix_size = min(12, 2 * k - 1)
    num_files_bits = min(6, prefix_size)
    num_blocks_bits = prefix_size - num_files_bits
    suffix_size = 2 * k - prefix_size
    if not (1 <= suffix_size <= 64):
        raise ValueError(f"bad prefix_size {prefix_size} for k={k}")
    num_files = 1 << num_files_bits
    num_blocks = 1 << num_blocks_bits
    os.makedirs(path, exist_ok=True)

    kmers = np.ascontiguousarray(kmers, np.uint64)
    counts = np.ascontiguousarray(counts, np.uint64)
    if len(counts) and int(counts.max()) > 0xFFFFFFFF:
        raise ValueError("counts exceed 32-bit meryl values")
    prefixes = (kmers >> np.uint64(suffix_size)).astype(np.int64)
    sufs_all = kmers & np.uint64((1 << suffix_size) - 1)
    # kmers are sorted, so each block prefix is one contiguous slice
    bounds = np.searchsorted(prefixes, np.arange((num_files * num_blocks) + 1))

    for fi in range(num_files):
        data = bytearray()
        index = np.zeros((num_blocks, 3), np.uint64)
        for bb in range(num_blocks):
            pref = (fi << num_blocks_bits) | bb
            lo, hi = int(bounds[pref]), int(bounds[pref + 1])
            index[bb, 0] = pref
            index[bb, 1] = len(data)
            index[bb, 2] = hi - lo
            data += native.meryl_encode_block(
                pref, sufs_all[lo:hi], counts[lo:hi], suffix_size, vct=1)
        with open(_block_name(path, fi, num_files_bits, False), "wb") as f:
            f.write(data)
        with open(_block_name(path, fi, num_files_bits, True), "wb") as f:
            f.write(index.tobytes())

    # master index with histogram stats (merylHistogram::dump,
    # kmers-v1/kmers-histogram.C:63-96)
    vals, occ = np.unique(counts, return_counts=True) if len(counts) \
        else (np.zeros(0, np.int64), np.zeros(0, np.int64))
    bw = _BitWriter(32 * 1024)
    bw.put(64, _M1_IDX)
    bw.put(64, _M2_IDX)
    bw.put(32, prefix_size)
    bw.put(32, suffix_size)
    bw.put(32, num_files_bits)
    bw.put(32, num_blocks_bits)
    bw.put(32, 0)  # flags (bit 0: multiset)
    n_unique = int(occ[vals == 1][0]) if np.any(vals == 1) else 0
    bw.put(64, n_unique)
    bw.put(64, int(len(kmers)))
    bw.put(64, int(counts.sum()))
    bw.put(64, len(vals))
    for v, o in zip(vals.tolist(), occ.tolist()):
        bw.put(64, int(v))
        bw.put(64, int(o))
    with open(os.path.join(path, "merylIndex"), "wb") as f:
        f.write(bw.dump())
