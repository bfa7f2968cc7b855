"""Weighted-minimizer sketching with the per-base transform on the device.

Counterpart of winnowmap_tpu/sketch/device.py for PyTorch and CUDA
(reference src/sketch.c:128-219 with applyWeight, :70-89; host oracle
native/src/wm_sketch.cpp).  The per-base transform (forward and reverse
k-mers, canonical k-mer and strand, the symmetric flag, the MurmurHash3
finalizer, the invertible key mix) runs on the device; HPC compaction,
the down-weight membership (sorted set or bloom), the f64 weight order and
the winnowing automaton (native.winnow) run on the host, as in the JAX
package, so the minimizers equal native.sketch exactly.

The transform has
  * a wrapper, transform, that launches S1 (csrc/sketch.cu, one thread a
    base) for CUDA tensors and counts the launch in LAUNCHES, and uses the
    plain version only for tensors on the CPU;
  * a plain PyTorch version, transform_plain, in int64: a product wraps as
    u64's does, and every right shift is masked, as torch has no logical
    right shift on int64.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..device import resolve_device

_NT4 = np.full(256, 4, np.uint8)
for _b, _v in zip(b"AaCcGgTtUu", [0, 0, 1, 1, 2, 2, 3, 3, 3, 3]):
    _NT4[_b] = _v

# kernel launches on this process; chip_smoke.py zeroes them around the
# main path to show it went through the kernel
LAUNCHES = {"sketch": 0}


def reset_launches() -> None:
    LAUNCHES["sketch"] = 0


def _i64(c: int) -> int:
    """A u64 constant as the int64 with its bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_M1 = _i64(0xFF51AFD7ED558CCD)
_M2 = _i64(0xC4CEB9FE1A85EC53)


def _shr(t: torch.Tensor, s: int) -> torch.Tensor:
    """The logical right shift of int64 bits."""
    return (t >> s) & ((1 << (64 - s)) - 1)


def transform_plain(codes: torch.Tensor, k: int):
    """The per-base transform in plain PyTorch: codes (n,) uint8 0..4 ->
    key, h, canon (n,) int64 holding u64 bits, z and sym (n,) uint8."""
    c = codes.to(torch.int64)
    valid = c < 4
    cc = torch.where(valid, c, 0)
    rc = torch.where(valid, 3 ^ c, 0)
    n = len(c)
    f = torch.zeros(n, dtype=torch.int64, device=c.device)
    r = torch.zeros_like(f)
    for j in range(min(k, n)):
        # c[i - j] contributes << 2j to f_i, (3 ^ c[i - j]) << 2(k-1-j) to r_i
        f[j:] += cc[:n - j] << (2 * j)
        r[j:] += rc[:n - j] << (2 * (k - 1 - j))
    canon = torch.minimum(f, r)  # both below 2^56: signed order is u64's
    h = canon ^ _shr(canon, 33)
    h = h * _M1
    h = h ^ _shr(h, 33)
    h = h * _M2
    h = h ^ _shr(h, 33)
    mask = (1 << (2 * k)) - 1
    key = (~canon + (canon << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    z = (f >= r).to(torch.uint8)
    sym = (f == r).to(torch.uint8)
    return key, h, z, sym, canon


def sketch_launch(lib, codes, k: int, words, flags, stream) -> int:
    """S1's C entry: key, h, canon into words (3, n) int64 and z, sym into
    flags (2, n) uint8.  Returns the CUDA error code."""
    return lib.wm_sketch_launch(codes.data_ptr(), codes.numel(), k,
                                words[0].data_ptr(), words[1].data_ptr(),
                                flags[0].data_ptr(), flags[1].data_ptr(),
                                words[2].data_ptr(), stream)


def transform(codes: torch.Tensor, k: int):
    """S1 for a CUDA tensor (the plain version for a CPU tensor): as
    transform_plain."""
    dev = codes.device
    if dev.type == "cpu":
        return transform_plain(codes, k)
    if not codes.is_cuda or not codes.is_contiguous() \
            or codes.dtype != torch.uint8:
        raise ValueError("codes must be a contiguous CUDA uint8 tensor")
    if not 0 < k <= 28:
        raise ValueError(f"k = {k} is outside 1..28")
    from ..extend import _build

    n = codes.numel()
    words = torch.empty((3, n), dtype=torch.int64, device=dev)
    flags = torch.empty((2, n), dtype=torch.uint8, device=dev)
    rc = sketch_launch(_build.load(), codes, k, words, flags,
                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sketch kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    LAUNCHES["sketch"] += 1
    return words[0], words[1], flags[0], flags[1], words[2]


def _bloom_contains_np(keys: np.ndarray, table: np.ndarray, bits: int,
                       s0: int, s1: int) -> np.ndarray:
    """Vectorized wm_bloom_contains (reference bloom_filter.hpp hash_ap +
    compute_indices over the 8 LE bytes of each canonical code)."""
    i1 = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    i2 = (keys >> np.uint64(32)).astype(np.uint32)
    out = np.ones(len(keys), bool)
    for salt in (np.uint32(s0), np.uint32(s1)):
        h = np.full(len(keys), salt, np.uint32)
        h ^= ((h << np.uint32(7)) ^ (i1 * (h >> np.uint32(3)))
              ^ (~((h << np.uint32(11)) + (i2 ^ (h >> np.uint32(5))))))
        b = h.astype(np.uint64) % np.uint64(bits)
        out &= (table[(b >> np.uint64(3)).astype(np.int64)]
                >> (b & np.uint64(7)).astype(np.uint8)) & 1 == 1
    return out


def _flagged(canon: np.ndarray, wset: np.ndarray, bloom) -> np.ndarray:
    """Which canonical k-mers are down-weighted: the bloom's membership in
    --bloom-filter mode, else the sorted set's."""
    if bloom is not None:
        table, bits, s0, s1 = bloom
        return _bloom_contains_np(canon, table, bits, s0, s1)
    if len(wset):
        ws = np.ascontiguousarray(wset, np.uint64)
        idx = np.minimum(np.searchsorted(ws, canon), len(ws) - 1)
        return ws[idx] == canon
    return np.zeros(len(canon), bool)


def sketch_device(seq: bytes, w: int, k: int, rid: int, is_hpc: bool,
                  wset: np.ndarray, bloom=None, device=None):
    """Sketch one sequence with the transform on `device` (None: the card)
    and the host's selection tail.  Returns (x, y) uint64 arrays equal to
    native.sketch's."""
    n = len(seq)
    if n <= 0 or w <= 0 or w >= 256 or k <= 0 or k > 28:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    codes_full = _NT4[np.frombuffer(seq, np.uint8)]
    if is_hpc:
        # compact homopolymer runs of valid bases; ambiguous bases stay
        # (they reset the window); skip_len is the kept base's run length,
        # and the reference reports the position of the run's end
        prev = np.concatenate([[255], codes_full[:-1]])
        keep = (codes_full != prev) | (codes_full >= 4)
        pos_all = np.nonzero(keep)[0]
        codes = codes_full[pos_all]
        run_end = np.concatenate([pos_all[1:], [n]])
        skip_len = (run_end - pos_all).astype(np.int64)
        base_pos = (run_end - 1).astype(np.int64)
    else:
        codes = codes_full
        skip_len = np.ones(len(codes), np.int64)
        base_pos = np.arange(len(codes), dtype=np.int64)
    dev = resolve_device(device)
    out = transform(torch.from_numpy(np.ascontiguousarray(codes)).to(dev), k)
    key, h, z, sym, canon = (t.cpu().numpy() for t in out)
    key, h, canon = key.view(np.uint64), h.view(np.uint64), \
        canon.view(np.uint64)
    flagged = _flagged(canon, wset, bloom)
    # the IEEE-double selection order of the oracle's weight_order (numpy
    # f64 operations round as C doubles do)
    x = h.astype(np.float64) / np.float64(np.uint64(0xFFFFFFFFFFFFFFFF))
    ordv = -x
    if flagged.any():
        xf = x[flagged]
        p2 = xf * xf
        p4 = p2 * p2
        ordv[flagged] = -(p4 * p4)
    return native.winnow(codes, key, z, sym, ordv, skip_len, base_pos, w, k,
                         rid, is_hpc)
