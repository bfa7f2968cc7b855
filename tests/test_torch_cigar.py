"""R1, the CIGARs of K2's op rows (extend/kernels.cigar_rle_plain, and the
source csrc/cigar.cu built against the stub CUDA runtime), against the
native decode it replaced (native.rle_ops_blob on 2-bit-packed rows,
rle_ops_blob4 on 4-bit rows with the spliced N rule); and DevCallPooled's
collect_blob on CPU tensors against that decode of the same call's K2
walks.  Every comparison is exact."""
import contextlib
import ctypes
import mmap

import numpy as np
import pytest
import torch

from winnowmap_tpu_torch import native
from winnowmap_tpu_torch.extend import check
from winnowmap_tpu_torch.extend import kernels as K
from winnowmap_tpu_torch.index.build import MinimizerIndex
from winnowmap_tpu_torch.map.align import gen_simple_mat
from winnowmap_tpu_torch.map.engine import STATS
from winnowmap_tpu_torch.tools import cuda_stub

torch.set_num_threads(1)

# (spliced, min_intron): K2's plain ops 0-2, its spliced ops 0-3 with
# splice's min_intron, and 0-3 with none
ALPHABETS = {"2bit": (False, 0), "4bit": (True, 30),
             "4bit-no-intron": (True, 0)}
RLE_CASES = [(a, rev, seed) for a in ALPHABETS for rev in (False, True)
             for seed in (1, 2)]


def split(blob, off, ln):
    words = blob.numpy().view(np.uint32)
    return [words[o:o + n] for o, n in zip(off.tolist(), ln.tolist())]


@pytest.mark.parametrize("name,rev,seed", RLE_CASES)
def test_cigar_rle_plain_matches_native(name, rev, seed):
    """Rows of very different lengths under one n_ops (check.random_op_rows),
    each way round, either alphabet, with and without the N rule."""
    spliced, min_intron = ALPHABETS[name]
    ops, fin, start = check.random_op_rows(np.random.default_rng(seed),
                                           spliced, min_intron)
    want = check.native_cigars(native, ops, fin, rev, spliced, min_intron)
    blob, off, ln = K.cigar_rle(torch.from_numpy(ops), torch.from_numpy(fin),
                                torch.from_numpy(start), rev, min_intron)
    assert int(off[-1] + ln[-1]) == blob.numel()
    assert np.array_equal(off.numpy(), np.cumsum(ln.numpy()) - ln.numpy())
    got = split(blob, off, ln)
    assert any(len(w) == 0 for w in want) and max(map(len, want)) > 100
    for b, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), (b, g, w)


@pytest.fixture(scope="module")
def stub_lib(tmp_path_factory):
    if cuda_stub.gxx_path() is None:
        pytest.skip("needs g++ to build the CUDA source against the stub "
                    "runtime")
    return cuda_stub.load("cigar.cu", tmp_path_factory.mktemp("stub_rle"))


PAGE = mmap.PAGESIZE


@contextlib.contextmanager
def guarded(a: np.ndarray, at_end: bool):
    """A copy of `a` in pages of its own, flush against an inaccessible
    page (after it with at_end, else before it): a read past that edge
    faults."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    n = -(-a.nbytes // PAGE) * PAGE
    mm = mmap.mmap(-1, n + 2 * PAGE)
    base = ctypes.addressof(ctypes.c_char.from_buffer(mm))
    at = PAGE + (n - a.nbytes if at_end else 0)
    view = np.frombuffer(mm, np.uint8, a.nbytes, at).reshape(a.shape)
    view[:] = a
    fence = base + (PAGE + n if at_end else 0)
    assert libc.mprotect(fence, PAGE, 0) == 0  # PROT_NONE
    try:
        yield torch.from_numpy(view)
    finally:
        libc.mprotect(fence, PAGE, mmap.PROT_READ | mmap.PROT_WRITE)


@pytest.mark.parametrize("name,rev,n_ops,fence", [
    ("2bit", False, 4112, "before"), ("4bit", True, 4112, "after"),
    ("4bit", False, 2052, "before"), ("2bit", True, 2052, "after")])
def test_cigar_rle_source_matches_plain(stub_lib, name, rev, n_ops, fence):
    """csrc/cigar.cu under the stub: its 16-byte loads (rows of 4,112
    slots) and its byte loads (2,052), four chunks a step, the scan; the
    rows flush against an inaccessible page before the first row or after
    the last, so no load may leave them."""
    spliced, min_intron = ALPHABETS[name]
    # the first job walks a few slots, the last the whole row
    ops_np, fin, start = (np.roll(a, -2, 0) for a in check.random_op_rows(
        np.random.default_rng(n_ops), spliced, min_intron, B=20, n_ops=n_ops))
    fin, start = torch.from_numpy(fin), torch.from_numpy(start)
    assert 0 <= start[0].sum() < 20 and start[-1].sum() == n_ops - 1
    B = len(ops_np)
    blob = torch.full((B * (n_ops + 2),), 7, dtype=torch.int32)
    off = torch.empty(B, dtype=torch.int64)
    ln = torch.empty(B, dtype=torch.int32)
    with guarded(ops_np, fence == "after") as ops:
        assert K.rle_launch(stub_lib, ops, fin, start, rev, min_intron, blob,
                            off, ln, None) == 0
    pb, po, pl = K.cigar_rle_plain(torch.from_numpy(ops_np), fin, start, rev,
                                   min_intron)
    assert torch.equal(off, po) and torch.equal(ln, pl)
    total = int(po[-1] + pl[-1])
    assert torch.equal(blob[:total], pb)
    assert bool((blob[total:] == 7).all())


# one call of each DP kernel's kind: (gaps, splice, flag); extd with the
# extz-only rule (reach) and rev_cigar, exts forward with the flank
# bonus, extz with the approximate max
POOLED = {
    "extd": ((4, 2, 24, 1), None, 0x40 | 0x80),
    "exts": ((2, 1, 32, 0), (9, 9), 0x100 | 0x400),
    "extz": ((4, 2, 4, 2), None, 0x08 | 0x10),
}


@pytest.mark.parametrize("kind", sorted(POOLED))
def test_collect_blob_matches_native_decode(kind):
    """DevCallPooled.collect_blob on CPU tensors returns what it returned
    when it decoded K2's packed rows on the host: the nine fields, each
    job's CIGAR, reach; collect_runs and collect_d2h_bytes count the
    words and bytes brought back."""
    gaps, splice, flag = POOLED[kind]
    rng = np.random.default_rng(5)
    if splice:
        qpool, tpool, jobs, *_ = check.spliced_jobs(
            rng, 6, exon_total=(120, 240), intron_len=(40, 300))
    else:
        qpool, tpool, jobs, _, _ = check.random_jobs(
            rng, rng.integers(40, 300, 7), rng.choice([-1, 33, 97], 8), 200,
            dissimilar=True)
    B = len(jobs)
    eb = rng.integers(0, 60, B)
    mat = gen_simple_mat(2, 4, 1) if not splice else gen_simple_mat(1, 2, 1)
    pools = K.PoolContext(qpool, MinimizerIndex(w=10, k=15, codes=tpool),
                          torch.device("cpu"))
    STATS.clear()
    res9, blob, off, ln, reach = K.DevCallPooled(
        pools, jobs, mat, *gaps[:3], gaps[3], eb, flag,
        splice=splice).collect_blob()
    c = check.OnDevice("cpu", qpool, tpool, jobs, mat, gaps[:3] if splice
                       else gaps, flag, eb, splice=splice)
    res, dirs = c.k1()
    ops, fin = c.k2(dirs, c.starts(res))
    want = c.cigars(native, ops, fin)
    r = res[:, :9].numpy()
    assert np.array_equal(res9, r)
    assert sum(len(w) for w in want) > B
    if splice:
        assert all(((w & 15) == 3).any() for w in want)
    for b in range(B):
        assert np.array_equal(blob[off[b]:off[b] + ln[b]], want[b]), b
    old_reach = np.zeros(B, np.int32)
    if flag & K.EZ_EXTZ_ONLY and not splice:
        old_reach = ((r[:, 1] == 0) & (r[:, 4] + eb > r[:, 0])).astype(
            np.int32)
        assert old_reach.any() and not old_reach.all()
    assert np.array_equal(reach, old_reach)
    runs = int(ln.sum())
    assert STATS["collect_runs"] == runs
    assert STATS["collect_d2h_bytes"] <= 96 * B + 4 * runs
