"""k-mer counting on the device: blocks of codes through KC, a sort-based
count (2-bit k-mers, sort, run-length encode), in place of meryl's threaded
bucket machinery (reference ext/meryl/src/meryl/merylOp-count*.C,
merylCountArray.C).

Counterpart of winnowmap_tpu/kcount/device.py for PyTorch and CUDA.  The
base codes of all records stream into blocks of BLOCK codes
(iter_code_blocks: k-1 invalid separators between records, the k-1 last
codes carried into the next block); each block goes through KC and comes
back as a sorted run of unique k-mers and their counts; the runs merge on
the host with the out-of-core counter's chunked two-pointer merge.

KC has
  * a wrapper, count_block, that launches the kernel (csrc/kcount.cu:
    encode and compact, a one-sweep LSD radix sort over the 2k key bits in
    u32 keys at k <= 16 and u64 above, a run-length encode) for a CUDA
    tensor and counts the launch in
    LAUNCHES, and runs the plain version only for a tensor on the CPU;
  * a plain PyTorch version, count_block_plain, in int64: the same rolls,
    a sort of the valid keys (their top bit flipped, so the signed order
    is u64's) and torch.unique_consecutive.
Unlike the JAX function, which marks an invalid window with the all-ones
key and drops every all-ones key, KC counts a valid all-ones k-mer (k =
32, poly-G forward or poly-C reverse), as the host counter does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import count, resolve_device
from . import MERYL_CODE, KmerCounts
from .outofcore import _merge_two, _Run

# codes a block (the tests patch it: read at call time)
BLOCK = 4 << 20
# the JAX function's mark of an invalid window, which also drops a valid
# all-ones k-mer (k = 32); KC makes no mark
SENTINEL = 0xFFFFFFFFFFFFFFFF
DIRECTIONS = {"canonical": 0, "forward": 1, "reverse": 2}
# csrc/kcount.cu's tile of keys a block of threads, its widest digit and
# its counter words (kc_scratch_words mirrors its Plan)
KC_TILE = 4096
KC_MAX_BITS = 8
KC_CTR_WORDS = 16
_TOP = torch.iinfo(torch.int64).min  # the u64 top bit as an int64

# kernel launches on this process; chip_smoke.py zeroes them around the
# main path to show it went through the kernel
LAUNCHES = {"kcount": 0}


def reset_launches() -> None:
    LAUNCHES["kcount"] = 0


def _check_args(k: int, direction: str) -> None:
    if not 0 < k <= 32:
        raise ValueError(f"k = {k} is outside 1..32")
    if direction not in DIRECTIONS:
        raise ValueError(f"unknown direction {direction!r}")


def _empty(dev):
    return (torch.zeros(0, dtype=torch.int64, device=dev),
            torch.zeros(0, dtype=torch.int64, device=dev))


def block_keys_plain(codes: torch.Tensor, k: int,
                     direction: str = "canonical") -> torch.Tensor:
    """The keys of the valid windows of codes (n,) uint8, 0..3 a base and
    anything else invalid, in window order: int64 holding u64 bits."""
    _check_args(k, direction)
    nw = codes.numel() - k + 1
    if nw <= 0:
        return torch.zeros(0, dtype=torch.int64, device=codes.device)
    c = codes.to(torch.int64)
    valid = c <= 3
    fwd = torch.zeros(nw, dtype=torch.int64, device=c.device)
    rev = torch.zeros_like(fwd)
    ok = torch.ones(nw, dtype=torch.bool, device=c.device)
    for j in range(k):
        cj = c[j:j + nw] & 3
        # a left shift drops the top bits as u64's does
        fwd = (fwd << 2) | cj
        rev = rev | ((cj ^ 2) << (2 * j))
        ok &= valid[j:j + nw]
    if direction == "forward":
        return fwd[ok]
    if direction == "reverse":
        return rev[ok]
    # u64 order on int64 bits: the signed order with the top bit flipped
    return (torch.minimum(fwd ^ _TOP, rev ^ _TOP) ^ _TOP)[ok]


def count_block_plain(codes: torch.Tensor, k: int,
                      direction: str = "canonical"):
    """KC in plain PyTorch: codes (n,) uint8 -> (k-mers, counts), the sorted
    unique keys of the valid windows (block_keys_plain) and their int64
    counts."""
    keys = block_keys_plain(codes, k, direction)
    # at k = 32 a key may have its top bit set: sort in u64 order
    s = torch.sort(keys ^ _TOP).values ^ _TOP
    return torch.unique_consecutive(s, return_counts=True)


def kc_plan(k: int) -> tuple:
    """KC's sort at k: (passes, digit bits), ceil(2k / KC_MAX_BITS) passes
    of equal digits."""
    passes = -(-2 * k // KC_MAX_BITS)
    return passes, -(-2 * k // passes)


def kc_scratch_words(n_win: int, k: int) -> int:
    """u32 words of KC's scratch table (csrc/kcount.cu's Plan): counters,
    the passes' digit totals, the encode pass's tile statuses, the run
    encode's (u64) and two rows of per-digit tile statuses."""
    passes, bits = kc_plan(k)
    tiles = -(-n_win // KC_TILE)
    w = KC_CTR_WORDS + passes * (1 << bits) + tiles
    w += w & 1
    return w + 2 * tiles + 2 * tiles * (1 << bits)


def kc_buffers(n_win: int, dev, k: int) -> dict:
    """KC's scratch and outputs for n_win windows at k: the two key buffers
    of the sort (u32 keys at k <= 16 take half of each), the scratch table,
    the live and unique counts, the unique k-mers and their counts."""
    return {"keys": torch.empty((2, n_win), dtype=torch.int64, device=dev),
            "tab": torch.empty(kc_scratch_words(n_win, k), dtype=torch.int32,
                               device=dev),
            "scal": torch.empty(2, dtype=torch.int32, device=dev),
            "uniq": torch.empty(n_win, dtype=torch.int64, device=dev),
            "counts": torch.empty(n_win, dtype=torch.int64, device=dev)}


def kcount_launch(lib, codes, k: int, direction: str, bufs: dict,
                  stream) -> int:
    """KC's C entry on codes with kc_buffers' tensors: the first
    bufs["scal"][1] entries of bufs["uniq"] and bufs["counts"] are the
    run.  Returns the CUDA error code (cudaErrorInvalidValue for a scratch
    table smaller than kc_scratch_words)."""
    b = bufs
    return lib.wm_kcount_launch(codes.data_ptr(), codes.numel(), k,
                                DIRECTIONS[direction], b["keys"].data_ptr(),
                                b["tab"].data_ptr(),
                                4 * b["tab"].numel(),
                                b["scal"].data_ptr(), b["uniq"].data_ptr(),
                                b["counts"].data_ptr(), stream)


def count_block_launch(codes: torch.Tensor, k: int,
                       direction: str = "canonical"):
    """KC on a CUDA tensor of at least k codes, without waiting for it:
    (uniq, counts, n_seg), the run being the first n_seg (a 0-d int32
    tensor on the card) entries of uniq and counts."""
    if not codes.is_cuda or not codes.is_contiguous() \
            or codes.dtype != torch.uint8:
        raise ValueError("codes must be a contiguous CUDA uint8 tensor")
    _check_args(k, direction)
    n_win = codes.numel() - k + 1
    if not 0 < n_win < 1 << 30:
        raise ValueError(f"{codes.numel()} codes at k = {k}: KC takes "
                         f"1 to 2^30 - 1 windows")
    from ..extend import _build

    dev = codes.device
    bufs = kc_buffers(n_win, dev, k)
    rc = kcount_launch(_build.load(), codes, k, direction, bufs,
                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"k-mer count kernel launch failed: cudaError "
                           f"{rc} ({_build.error_string(rc)})")
    count(LAUNCHES, "kcount")
    return bufs["uniq"], bufs["counts"], bufs["scal"][1]


def count_block(codes: torch.Tensor, k: int, direction: str = "canonical"):
    """KC for a CUDA tensor (the plain version for a CPU tensor): as
    count_block_plain."""
    if codes.device.type == "cpu":
        return count_block_plain(codes, k, direction)
    _check_args(k, direction)
    if codes.numel() < k:
        return _empty(codes.device)
    uniq, counts, n_seg = count_block_launch(codes, k, direction)
    n = int(n_seg)
    return uniq[:n], counts[:n]


def iter_code_blocks(records, k: int, n_block: int | None = None):
    """Base-code blocks of n_block codes (the last one shorter) spanning
    record boundaries, with k-1 invalid separators between records (so no
    k-mer crosses two records) and the k-1 last codes of a full block
    carried into the next (so a window across two blocks is counted
    once)."""
    if n_block is None:
        n_block = BLOCK  # module attribute at call time (tests patch it)
    buf = np.full(n_block, 255, np.uint8)
    fill = 0
    sep = np.full(k - 1, 255, np.uint8)
    for ri, rec in enumerate(records):
        codes = MERYL_CODE[np.frombuffer(rec.seq, dtype=np.uint8)]
        if ri > 0:
            codes = np.concatenate([sep, codes])
        o = 0
        while o < len(codes):
            take = min(len(codes) - o, n_block - fill)
            buf[fill:fill + take] = codes[o:o + take]
            fill += take
            o += take
            if fill == n_block:
                yield buf
                # windows spanning block boundaries: carry k-1 tail codes
                buf = np.full(n_block, 255, np.uint8)
                buf[:k - 1] = codes[o - (k - 1):o] if o >= k - 1 else 255
                fill = k - 1 if o >= k - 1 else 0
    if fill:
        yield buf[:fill]


def count_kmers_device(records, k: int, direction: str = "canonical",
                       device=None) -> KmerCounts:
    """Counts the k-mers of records block by block through KC on `device`
    (None: the card) and merges the blocks' runs on the host: the counted
    set of the host counter (outofcore.count_kmers_chunked)."""
    _check_args(k, direction)
    dev = resolve_device(device)
    runs = []
    for buf in iter_code_blocks(records, k):
        if len(buf) < k:
            continue
        km, ct = count_block(torch.from_numpy(buf).to(dev), k, direction)
        if len(km) == 0:
            continue
        runs.append(_Run(km.cpu().numpy().view(np.uint64), ct.cpu().numpy(),
                         None))
    if not runs:
        return KmerCounts(k, np.zeros(0, np.uint64), np.zeros(0, np.int64))
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(_merge_two(runs[i], runs[i + 1], None, 1 << 22))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return KmerCounts(k, np.asarray(runs[0].kmers),
                      np.asarray(runs[0].counts))
