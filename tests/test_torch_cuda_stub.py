"""K1 (csrc/extd.cu) and K4 (csrc/extz.cu), C1 (csrc/chain.cu), S1
(csrc/sketch.cu: the transform, the down-weight membership and the f64
order) and KC (csrc/kcount.cu), the CUDA sources themselves, run
on the CPU against their plain PyTorch versions: the sources are compiled
by g++ against the stub CUDA runtime of winnowmap_tpu_torch/tools/cuda_stub
(one fiber per CUDA thread) and launched through kernels.ext_launch,
chain.chain_launch, sketch.sketch_launch and kcount.device.kcount_launch,
the marshalling the wrappers use on the card.
Integer DP, u64 words and S1's f64 order: every result field, every
direction byte and every output word (the order's bits) must be equal.

Each case is about four jobs of 100-400 bases, at one launch of
kernels.ext_geometry: 128 threads with 1-8 ring slots a thread (rings of
128 and 256 lanes wrap, the band passing the ring's end; 384-1024 are
rings wider than the band), and the memory path at 512 threads with the
slot state in shared memory or global scratch (its ring wraps too).
"""
import numpy as np
import pytest
import torch

from winnowmap_tpu_torch.extend import check
from winnowmap_tpu_torch.extend import kernels as K
from winnowmap_tpu_torch.map.align import gen_simple_mat
from winnowmap_tpu_torch.tools import cuda_stub

torch.set_num_threads(1)

# (a, b, q, e, q2, e2): map-ont and asm5 (extd; asm5's q2 = 81 drives int8
# wraps), one gap cost and the profile whose biased score byte wraps (q + e
# = 63, max_sc = 128; extz)
PROFILES = {"map-ont": (2, 4, 4, 2, 24, 1), "asm5": (1, 19, 39, 3, 81, 1),
            "single": (2, 4, 4, 2, 4, 2), "wrap": (2, 4, 61, 2, 61, 2)}
FLAGS = (0x0, 0x18, 0x02 | 0x80, 0x01)
# slots a thread -> (job lengths, band widths w): bands whose span takes a
# ring of 128 and 256 lanes under targets longer than the ring; rings of
# 384-1024 lanes forced on jobs of 100-300 bases (span <= 337)
LAUNCHES = {1: ((150, 320), (33, 64)), 2: ((250, 400), (97, 150))}
SHORT = ((100, 300), (-1, 200))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if cuda_stub.gxx_path() is None:
        pytest.skip("needs g++ to build the CUDA sources against the stub "
                    "runtime")
    d = tmp_path_factory.mktemp("cuda_stub")
    return {m: cuda_stub.load(f"{m}.cu", d) for m in ("extd", "extz")}


def _batch(profile, flag, lens, ws, seed):
    rng = np.random.default_rng(seed)
    n = rng.integers(lens[0], lens[1], 3)
    zdrop = -1 if profile == "wrap" else rng.choice([40, 200], 4)
    qp, tp, jobs, _, _ = check.random_jobs(rng, n, rng.choice(ws, 4), zdrop,
                                           dissimilar=True)
    a, b, q, e, q2, e2 = PROFILES[profile]
    return check.OnDevice("cpu", qp, tp, jobs, gen_simple_mat(a, b, 1),
                          (q, e, q2, e2), flag, rng.integers(0, 60, 4))


def _run_stub(libs, c: check.OnDevice, geo: K.ExtGeometry):
    """The source's kernel at `geo` and the plain version on c's jobs:
    every result field and direction byte equal."""
    res_p, dirs_p = c.k1_plain()
    res = torch.zeros_like(res_p)
    dirs = torch.zeros_like(dirs_p)
    assert geo.ring >= c.geo.span
    rc = K.ext_launch(libs[c.dp_name], c.dp_name, geo, c.prof, c.flag,
                      c.qpool, c.tpool, c.jobs, c.off, dirs, res, None)
    assert rc == 0
    assert torch.equal(res[:, :9], res_p[:, :9])
    assert torch.equal(dirs, dirs_p)


CASES = [(p, f, i % 8 + 1) for i, (p, f) in
         enumerate((p, f) for p in PROFILES for f in FLAGS)]


@pytest.mark.parametrize("profile,flag,spt", CASES,
                         ids=[f"{p}-flag{f:#04x}-x{n}" for p, f, n in CASES])
def test_ext_source_matches_plain(libs, profile, flag, spt):
    """Every profile at every flag, each at one register launch: 128
    threads with 1-8 slots, each launch twice."""
    lens, ws = LAUNCHES.get(spt, SHORT)
    c = _batch(profile, flag, lens, ws, seed=7 * spt + len(profile))
    geo = c.ext if spt <= 2 else K.ext_geometry(128 * spt, c.geo.qlen_max)
    assert (geo.threads, geo.spt, geo.ring) == (128, spt, 128 * spt)
    if spt <= 2:
        assert (c.jobs_np[:, 4] > geo.ring).any()  # the band wraps the ring
    _run_stub(libs, c, geo)


@pytest.mark.parametrize("profile,flag,path", [
    ("map-ont", 0x0, "mem-global"), ("wrap", 0x18, "mem-smem")])
def test_ext_source_memory_path_matches_plain(libs, profile, flag, path,
                                              monkeypatch):
    """The memory path (no register variant), its slot state in global
    scratch or shared memory, for each cell."""
    monkeypatch.setattr(K, "EXT_VARIANTS", {})
    if path == "mem-global":
        monkeypatch.setattr(K, "EXT_SMEM_MAX", 0)
    c = _batch(profile, flag, (540, 640), (97, 150), seed=3)
    assert c.ext.path == path and c.ext.threads == K.EXT_MEM_THREADS
    assert (c.jobs_np[:, 4] > c.ext.ring).any()
    _run_stub(libs, c, c.ext)


@pytest.fixture(scope="module")
def chain_sketch_libs(tmp_path_factory):
    if cuda_stub.gxx_path() is None:
        pytest.skip("needs g++ to build the CUDA sources against the stub "
                    "runtime")
    d = tmp_path_factory.mktemp("cuda_stub_cs")
    return {m: cuda_stub.load(f"{m}.cu", d)
            for m in ("chain", "sketch", "kcount")}


@pytest.mark.parametrize("is_cdna,max_skip", [(0, 25), (1, 25), (0, 1)],
                         ids=["dna", "cdna", "skip1"])
def test_chain_source_matches_plain(chain_sketch_libs, is_cdna, max_skip):
    """C1 on six anchor sets (colinear clusters, two repeat clusters whose
    windows span many tiles of 32, one of a single anchor) in two blocks of
    four warps, one warp idle: f, pre and v equal the plain version's.
    At max_skip 1 the oracle's break (its marks and floored skip counter)
    stops walks short of better predecessors."""
    from winnowmap_tpu_torch.chain import device as CD
    from winnowmap_tpu_torch.chain.check import anchor_set

    rng = np.random.default_rng(31 + is_cdna)
    jobs = [anchor_set(rng, int(rng.integers(100, 600)),
                       repeat=(t % 3 == 0)) for t in range(6)]
    jobs[5] = (jobs[5][0][:1], jobs[5][1][:1])
    p = (5000, 5000, 500, max_skip, is_cdna, 0.8)
    cj = CD.chain_jobs(jobs, 5000, 1000, 5000, "cpu")
    want = CD.chain_fwd_plain(cj, *p)
    out = torch.full_like(want, 7)
    assert CD.chain_launch(chain_sketch_libs["chain"], cj, *p, out,
                           None) == 0
    assert torch.equal(out, want)


def _colinear(rng, n, step):
    """(ax, ay) of one colinear run of n anchors, `step` apart with 0-2 of
    jitter, q_span 15."""
    x = (1 << 20) + np.arange(n) * step + rng.integers(0, 3, n)
    y = 1000 + np.arange(n) * step + rng.integers(0, 3, n)
    span = np.full(n, 15, np.uint64)
    ax = (np.uint64(1) << np.uint64(32)) | x.astype(np.uint64)
    ay = (span << np.uint64(32)) | y.astype(np.uint64)
    o = np.argsort(ax, kind="stable")
    return ax[o], ay[o]


@pytest.mark.parametrize("case", ["gapped", "gapped-long", "gapped-near",
                                  "walk"])
def test_chain_source_past_the_ring_matches_plain(chain_sketch_libs, case):
    """C1 where windows reach past its shared-memory ring (RING_REACH
    predecessors), under asm5's stage-2 gaps: "gapped", chain.check's
    gapped_set, whose walk across 1,100 noise anchors takes a predecessor
    and breaks on marks outside the ring (x, y, f, pre, v and the marks
    read from global memory), beside a short run; "gapped-long", its C1
    of 150 anchors behind 1,099 noise anchors at max_skip 103, the largest
    whose walk breaks in C1 (after marks carried over three steps of 64,
    a marked anchor on the steps' boundary): one mark too few reaches C0;
    "gapped-near", the same with no noise, at max_skip 96: A's walk starts
    in C1, its second predecessor marked by the first, and breaks one
    mark short of C0; "walk", a colinear run of 1,400 anchors 5 apart at
    a max_skip no walk reaches, so every anchor scans its whole window, up
    to 1,399 back, marking through both routes.  f, pre and v equal the
    plain version's."""
    from winnowmap_tpu_torch.chain import device as CD
    from winnowmap_tpu_torch.chain.check import gapped_set

    rng = np.random.default_rng(41)
    if case == "gapped":
        jobs, max_skip = [gapped_set(rng), _colinear(rng, 50, 7)], 25
    elif case == "gapped-long":
        jobs, max_skip = [gapped_set(rng, 1099, 150)], 103
    elif case == "gapped-near":
        jobs, max_skip = [gapped_set(np.random.default_rng(42), 0, 150)], 96
    else:
        jobs, max_skip = [_colinear(rng, 1400, 5)], 1 << 20
    cj = CD.chain_jobs(jobs, 16000, 1000, 5000, "cpu")
    local = torch.arange(cj.x.numel()) - torch.repeat_interleave(
        cj.off[:-1], cj.off.diff())
    if case != "gapped-near":
        assert int((local - cj.st).max()) > CD.RING_REACH
    p = (16000, 16000, 2000, max_skip, 0, 1.0)
    want = CD.chain_fwd_plain(cj, *p)
    if case in ("gapped", "gapped-long"):  # a predecessor past the ring
        assert int((local - want[1])[want[1] >= 0].max()) > CD.RING_REACH
    out = torch.full_like(want, 7)
    assert CD.chain_launch(chain_sketch_libs["chain"], cj, *p, out,
                           None) == 0
    assert torch.equal(out, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_chain_source_short_chains_any_schedule(chain_sketch_libs, seed):
    """C1 on chain.check's short_sets (1-12 anchors, and lengths that are
    not multiples of 8), where a chain ends inside the walking warp's wait
    for the producer warps' next anchors, under asm5's stage-2 gaps: with
    the stub's fibers in their default order (seed 0) and in five random
    orders, so that either producer may lag the other (a read of a slot not
    yet scored sees the stub's 0xA5 fill).  f, pre and v equal the plain
    version's, and each set chained to the end equals native.chain_dp."""
    import ctypes

    from winnowmap_tpu_torch import native
    from winnowmap_tpu_torch.chain import device as CD
    from winnowmap_tpu_torch.chain.check import short_sets

    p = dict(max_dist_x=16000, min_dist_x=1000, max_dist_y=16000, bw=2000,
             max_skip=25, max_iter=5000, min_cnt=3, min_sc=40,
             gap_scale=1.0, is_cdna=0)
    jobs = short_sets(np.random.default_rng(50 + seed))
    cj = CD.chain_jobs(jobs, p["max_dist_x"], p["min_dist_x"],
                       p["max_iter"], "cpu")
    args = (p["max_dist_x"], p["max_dist_y"], p["bw"], p["max_skip"],
            p["is_cdna"], p["gap_scale"])
    want = CD.chain_fwd_plain(cj, *args)
    out = torch.full_like(want, 7)
    lib = chain_sketch_libs["chain"]
    lib.cuda_stub_schedule.argtypes = [ctypes.c_ulonglong]
    lib.cuda_stub_schedule(seed)
    try:
        assert CD.chain_launch(lib, cj, *args, out, None) == 0
    finally:
        lib.cuda_stub_schedule(0)
    assert torch.equal(out, want)
    off = cj.off.tolist()
    for b, (ax, ay) in enumerate(jobs):
        f, pre, v = out[:, off[b]:off[b + 1]].numpy()
        got = native.chain_finish(f, pre, v, p["min_cnt"], p["min_sc"], ax,
                                  ay)
        assert all(np.array_equal(x, y) for x, y in zip(
            native.chain_dp(ax, ay, n_segs=1, **p), got))


def _sketch_case(k, n, mode, seed):
    """n codes with N runs (a partial last stretch of the kernel's 512) and
    the weights of `mode`: none; a sorted set of every 9th canonical k-mer
    from the second to the second-to-last (its ends hit, the smallest and
    largest k-mer just outside), `n_set` entries long with values no window
    holds; or the bloom table of that set."""
    from winnowmap_tpu_torch.index.build import weight_bloom
    from winnowmap_tpu_torch.sketch import device as SD

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    for at in rng.integers(0, n - 40, 5):
        codes[at:at + int(rng.integers(1, 40))] = 4
    ct = torch.from_numpy(codes)
    if mode == "none":
        return ct, SD.weights_on(None, None, "cpu")
    u = np.unique(SD.transform_plain(ct, k)[4].numpy().view(np.uint64))
    inner = u[1:-1]
    extra = rng.integers(int(inner[0]) + 1, int(inner[-1]), 3 * len(inner),
                         dtype=np.uint64)
    ws = np.unique(np.concatenate([inner[::9], inner[-1:], extra]))
    if mode == "set":
        return ct, SD.weights_on(ws, None, "cpu")
    return ct, SD.weights_on(None, weight_bloom(ws), "cpu")


def _run_sketch(lib, codes, k, wt):
    from winnowmap_tpu_torch.sketch import device as SD

    n = len(codes)
    out = (torch.full((n,), 7, dtype=torch.int64),
           torch.full((n,), 7.0, dtype=torch.float64),
           torch.full((n,), 7, dtype=torch.uint8))
    assert SD.sketch_launch(lib, codes, k, wt, *out, None) == 0
    key, ordv, flags = SD.sketch_plain(codes, k, wt)
    assert torch.equal(out[0], key)
    assert torch.equal(out[1].view(torch.int64), ordv.view(torch.int64))
    assert torch.equal(out[2], flags)


@pytest.mark.parametrize("k", [15, 28])
def test_sketch_source_matches_plain(chain_sketch_libs, k):
    """S1 on 1,301 codes with ambiguous bases (three stretches of 512, the
    last partial), with no set, with a sorted set (its first and last
    entries hit) and in bloom mode: the key, the order's bits and the flags
    byte equal the plain version's."""
    from winnowmap_tpu_torch.sketch import device as SD

    for mode in ("none", "set", "bloom"):
        codes, wt = _sketch_case(k, 1301, mode, k)
        _run_sketch(chain_sketch_libs["sketch"], codes, k, wt)
        down = SD.flagged_plain(SD.transform_plain(codes, k)[4], wt)
        assert down.any() == (mode != "none")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sketch_source_two_level_set_any_schedule(chain_sketch_libs, seed):
    """S1 at k = 19 on 5,000 codes with a sorted set of over 2,048 entries
    (more than the shared prefix holds, so each lookup also searches a
    stretch in device memory), in bloom mode and at k = 5; the stub's
    fibers in their default order (seed 0) and in two random orders."""
    import ctypes

    lib = chain_sketch_libs["sketch"]
    lib.cuda_stub_schedule.argtypes = [ctypes.c_ulonglong]
    lib.cuda_stub_schedule(seed)
    try:
        for k, mode in ((19, "set"), (19, "bloom"), (5, "set")):
            codes, wt = _sketch_case(k, 5000, mode, 40 + seed)
            if k == 19 and mode == "set":
                assert len(wt.wset) > 2048
            _run_sketch(lib, codes, k, wt)
    finally:
        lib.cuda_stub_schedule(0)


def test_sketch_source_refuses_misaligned(chain_sketch_libs):
    """The C entry reads and writes 16-byte vectors: codes or outputs off a
    16-byte boundary are refused (cudaErrorInvalidValue), as is k = 29."""
    from winnowmap_tpu_torch.sketch import device as SD

    lib = chain_sketch_libs["sketch"]
    codes, wt = _sketch_case(15, 1000, "none", 3)
    buf = torch.zeros(1001, dtype=torch.uint8)
    out = (torch.zeros(1000, dtype=torch.int64),
           torch.zeros(1000, dtype=torch.float64),
           torch.zeros(1000, dtype=torch.uint8))
    assert SD.sketch_launch(lib, buf[1:], 15, wt, *out, None) == 1
    assert SD.sketch_launch(lib, codes, 29, wt, *out, None) == 1
    flags = torch.zeros(1001, dtype=torch.uint8)[1:]
    assert SD.sketch_launch(lib, codes, 15, wt, out[0], out[1], flags,
                            None) == 1
    assert SD.sketch_launch(lib, codes, 15, wt, *out, None) == 0


def _kc_codes(rng, n, k):
    """n codes with N runs; for k = 15 the last 4000 invalid (a whole tile
    of 4096 windows without a key: the later passes' empty tiles); for
    k = 31 a poly-G stretch (runs of one key); for k = 32 a poly-G block,
    whose forward all-ones k-mer KC counts."""
    if k == 32:
        return np.full(n, 3, np.uint8)
    c = rng.integers(0, 4, n).astype(np.uint8)
    for _ in range(5):
        at = int(rng.integers(0, n - 30))
        c[at:at + int(rng.integers(1, 30))] = 255
    if k == 15:
        c[-4000:] = 255
    else:
        c[1000:1400] = 3
    return c


@pytest.mark.parametrize("k,n", [(15, 9000), (31, 5000), (32, 2000)])
@pytest.mark.parametrize("direction", ["canonical", "forward", "reverse"])
def test_kcount_source_matches_plain(chain_sketch_libs, k, n, direction):
    """KC on n codes (two or three tiles of 4096 windows, the last
    partial): the sorted unique k-mers, their counts, the number of valid
    windows and n_seg equal the plain version's."""
    from winnowmap_tpu_torch.kcount import device as KD

    codes = torch.from_numpy(_kc_codes(np.random.default_rng(k), n, k))
    bufs = KD.kc_buffers(n - k + 1, "cpu", k)
    assert KD.kcount_launch(chain_sketch_libs["kcount"], codes, k,
                            direction, bufs, None) == 0
    km, ct = KD.count_block_plain(codes, k, direction)
    n_live, n_seg = bufs["scal"].tolist()
    assert n_seg == len(km) > 0 and n_live == int(ct.sum())
    assert torch.equal(bufs["uniq"][:n_seg], km)
    assert torch.equal(bufs["counts"][:n_seg], ct)


def _kc_tiles_codes(rng, n):
    """n codes with N runs and a poly-G run of 9,000 codes from 10,000,
    whose one k-mer's run of sorted keys spans whole tiles of 4096: tiles
    of the run-length encode with no run start."""
    c = rng.integers(0, 4, n).astype(np.uint8)
    for at in rng.integers(0, n - 200, 12):
        c[at:at + int(rng.integers(1, 200))] = 255
    c[10_000:19_000] = 3
    return c


@pytest.mark.parametrize("k", [15, 19], ids=["u32", "u64"])
@pytest.mark.parametrize("direction", ["canonical", "forward", "reverse"])
def test_kcount_source_lookbacks_across_tiles(chain_sketch_libs, k,
                                              direction):
    """KC on 40,000 codes: ten tiles of 4096 keys, so every pass's
    look-backs chain across tiles; k = 15 sorts u32 keys in four passes
    of 8 bits, k = 19 u64 keys in five.  The results equal the plain
    version's; a scratch table one word short is refused."""
    from winnowmap_tpu_torch.kcount import device as KD

    n = 40_000
    codes = torch.from_numpy(_kc_tiles_codes(np.random.default_rng(k), n))
    assert -(-(n - k + 1) // KD.KC_TILE) >= 8
    bufs = KD.kc_buffers(n - k + 1, "cpu", k)
    short = dict(bufs, tab=bufs["tab"][:-1])
    assert KD.kcount_launch(chain_sketch_libs["kcount"], codes, k,
                            direction, short, None) != 0
    assert KD.kcount_launch(chain_sketch_libs["kcount"], codes, k,
                            direction, bufs, None) == 0
    km, ct = KD.count_block_plain(codes, k, direction)
    n_live, n_seg = bufs["scal"].tolist()
    assert n_seg == len(km) and n_live == int(ct.sum())
    assert torch.equal(bufs["uniq"][:n_seg], km)
    assert torch.equal(bufs["counts"][:n_seg], ct)
    assert int(ct.max()) > 2 * KD.KC_TILE  # the poly-G run
