"""Reference `MMI\\2` prebuilt-index interop (reference mm_idx_dump /
mm_idx_load, src/index.c:515-608).

The reference container is a bucketed khash dump: 2^b buckets, each with a
sorted occurrence array ``p`` plus a hash of minimizer-high-bits -> either
the single occurrence (key LSB set, src/index.c:97-100) or
(offset<<32 | count) into ``p`` (src/index.c:229-238).  Loading converts
that into our flat sorted-array index (keys/start/pos — index/build.py);
dumping distributes our runs back into buckets.  Entry order inside a
bucket's hash dump is arbitrary in the reference (khash iteration), so we
write ascending-key order; the reference loader accepts any order.

Query-side weighting note: the reference's mm_idx_load does NOT restore the
down-weight bloom filter (src/index.c:556-608 never touches downFilter), so
with a prebuilt index the reference sketches QUERIES unweighted.  Loading
an MMI therefore leaves mi.wset empty, byte-matching that behaviour; our
own WMTI1 container persists the weight set and keeps query weighting.
"""
from __future__ import annotations

import struct

import numpy as np

from .build import MinimizerIndex, SeqMeta

MMI_MAGIC = b"MMI\x02"
DEFAULT_B = 14  # reference bucket_bits default (src/options.c:9)


def _runs_gather(src: np.ndarray, offs: np.ndarray,
                 cnts: np.ndarray) -> np.ndarray:
    """Concatenate src[offs[i]:offs[i]+cnts[i]] for all i (vectorized)."""
    total = int(cnts.sum())
    if total == 0:
        return src[:0]
    base = np.repeat(offs, cnts)
    local = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(cnts) - cnts, cnts)
    return src[base + local]


def load_mmi(path: str) -> MinimizerIndex:
    """Read a reference-format prebuilt index into the flat sorted-array
    index (reference mm_idx_load, src/index.c:556-608)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MMI_MAGIC:
        raise ValueError(f"{path}: not an MMI\\2 index")
    w, k, b, n_seq, flag = struct.unpack_from("<5I", data, 4)
    o = 4 + 20
    mi = MinimizerIndex(w=w, k=k, flag=flag)
    sum_len = 0
    for _ in range(n_seq):
        (ln,) = struct.unpack_from("<B", data, o)
        o += 1
        name = data[o:o + ln].decode()
        o += ln
        (slen,) = struct.unpack_from("<I", data, o)
        o += 4
        mi.seqs.append(SeqMeta(name, sum_len, slen))
        sum_len += slen
    keys_parts, cnts_parts, pos_parts = [], [], []
    for i in range(1 << b):
        (n,) = struct.unpack_from("<I", data, o)
        o += 4
        p = np.frombuffer(data, np.uint64, n, o)
        o += 8 * n
        (size,) = struct.unpack_from("<I", data, o)
        o += 4
        if size == 0:
            continue
        pairs = np.frombuffer(data, np.uint64, 2 * size, o).reshape(size, 2)
        o += 16 * size
        hk, hv = pairs[:, 0], pairs[:, 1]
        full = ((hk >> np.uint64(1)) << np.uint64(b)) | np.uint64(i)
        single = (hk & np.uint64(1)) != 0
        cnt = np.where(single, 1, hv & np.uint64(0xFFFFFFFF)).astype(np.int64)
        order = np.argsort(full, kind="stable")
        full, hv, single, cnt = full[order], hv[order], single[order], \
            cnt[order]
        # emit each entry's run: the single value, or its slice of p
        out = np.empty(int(cnt.sum()), np.uint64)
        out_off = np.cumsum(cnt) - cnt
        out[out_off[single]] = hv[single]
        multi = ~single
        if multi.any():
            offs = (hv[multi] >> np.uint64(32)).astype(np.int64)
            mcnt = cnt[multi]
            vals = _runs_gather(p, offs, mcnt)
            base = np.repeat(out_off[multi], mcnt)
            local = np.arange(len(vals), dtype=np.int64) - np.repeat(
                np.cumsum(mcnt) - mcnt, mcnt)
            out[base + local] = vals
        keys_parts.append(full)
        cnts_parts.append(cnt)
        pos_parts.append(out)
    if keys_parts:
        keys = np.concatenate(keys_parts)
        cnts = np.concatenate(cnts_parts)
        pos = np.concatenate(pos_parts)
        # buckets are low-b-bit classes: global ascending order needs one
        # final permutation of keys and their runs
        order = np.argsort(keys, kind="stable")
        src_off = np.cumsum(cnts) - cnts
        pos = _runs_gather(pos, src_off[order], cnts[order])
        keys = keys[order]
        cnts = cnts[order]
    else:
        keys = np.zeros(0, np.uint64)
        cnts = np.zeros(0, np.int64)
        pos = np.zeros(0, np.uint64)
    mi.keys = keys
    mi.start = np.concatenate([[0], np.cumsum(cnts)]).astype(np.int64)
    mi.pos = pos
    # 4-bit packed reference (8 codes per uint32, src/index.c:552-553)
    if not (flag & 2):  # MM_I_NO_SEQ
        nwords = (sum_len + 7) // 8
        S = np.frombuffer(data, np.uint32, nwords, o)
        idx = np.arange(sum_len, dtype=np.int64)
        mi.codes = ((S[idx >> 3] >> ((idx & 7) << 2))
                    & np.uint32(0xF)).astype(np.uint8)
    else:
        mi.codes = np.zeros(0, np.uint8)
    return mi


def dump_mmi(mi: MinimizerIndex, path: str, b: int = DEFAULT_B) -> None:
    """Write our index as a reference-loadable MMI\\2 container (reference
    mm_idx_dump, src/index.c:515-554)."""
    mask = np.uint64((1 << b) - 1)
    keys = mi.keys
    cnts = (mi.start[1:] - mi.start[:-1]).astype(np.int64)
    bucket = (keys & mask).astype(np.int64)
    horder = np.argsort(bucket, kind="stable")  # keys stay ascending within
    with open(path, "wb") as f:
        f.write(MMI_MAGIC)
        f.write(struct.pack("<5I", mi.w, mi.k, b, mi.n_seq, mi.flag))
        for s in mi.seqs:
            name = s.name.encode()
            f.write(struct.pack("<B", len(name)))
            f.write(name)
            f.write(struct.pack("<I", s.length))
        bounds = np.searchsorted(bucket[horder], np.arange((1 << b) + 1))
        for i in range(1 << b):
            lo, hi = bounds[i], bounds[i + 1]
            sel = horder[lo:hi]
            ks, cs = keys[sel], cnts[sel]
            multi = cs > 1
            # p = concatenated multi-occurrence runs, in hash-entry order
            p = _runs_gather(mi.pos, mi.start[:-1][sel][multi], cs[multi])
            f.write(struct.pack("<I", len(p)))
            f.write(np.ascontiguousarray(p, np.uint64).tobytes())
            f.write(struct.pack("<I", len(ks)))
            if len(ks) == 0:
                continue
            hk = (ks >> np.uint64(b)) << np.uint64(1)
            hk = hk | np.uint64(1) * (~multi)
            hv = np.empty(len(ks), np.uint64)
            # singletons store the lone occurrence record directly
            starts = mi.start[:-1][sel]
            hv[~multi] = mi.pos[starts[~multi]]
            moff = np.cumsum(cs[multi]) - cs[multi]
            hv[multi] = (moff.astype(np.uint64) << np.uint64(32)) \
                | cs[multi].astype(np.uint64)
            pairs = np.empty((len(ks), 2), np.uint64)
            pairs[:, 0] = hk
            pairs[:, 1] = hv
            f.write(pairs.tobytes())
        if not (mi.flag & 2):
            sum_len = sum(s.length for s in mi.seqs)
            S = np.zeros((sum_len + 7) // 8, np.uint32)
            idx = np.arange(sum_len, dtype=np.int64)
            codes = mi.codes[:sum_len].astype(np.uint32)
            np.bitwise_or.at(S, idx >> 3, codes << ((idx & 7) << 2))
            f.write(S.tobytes())


def is_mmi_file(path: str) -> bool:
    """Reference prebuilt-index auto-detect (mm_idx_is_idx,
    src/index.c:610-633)."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == MMI_MAGIC
    except OSError:
        return False
