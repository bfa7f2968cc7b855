"""P3 (core_kernel), P2 (l0_kernel) and P1 (bisect_kernel) of
csrc/probes.cu, the CUDA source itself, run on the CPU against their plain
PyTorch versions: the source is compiled by g++ against the stub CUDA
runtime of winnowmap_tpu_torch/tools/cuda_stub (one fiber per CUDA thread)
and launched through probe_core.core_launch, probe_l0.l0_launch and
probe_bisect.bisect_launch, the marshalling the wrappers use on the card.
Integer code: res, the final state, the dirs where the probe defines them
(P3 from level 3 on, P1 under dirs_store) and P3's work counts must be
equal.  The outputs start filled with a byte pattern, so an element the
kernel leaves unwritten shows.

P3 is five warps a job up to 640 lanes, a chunk of 128 lanes each, with a
barrier a row; at Wb 128 only warp 0's chunk lies in the window, at Wb
640 all five exchange their edges.  Above 640 lanes (the wide launch) a
job is a warp a chunk up to 32 warps, each warp taking several chunks in
turn past 4,096 lanes, its buffers in a scratch slot: Wb 641, 1000,
2048, 4096 and 5000 at level 6, every case at 5000, and the after-done
rows at four widths.  Inputs are tools/check.small_inputs cut to 4 jobs:
job 0 (qlen 1) sets done in step 3 of 4 at levels 4-5 (ROWS 32), so its
last step runs the frozen walk; at Wb 640 and 11 steps the timed inputs
(jobs 2-3) set done at level 6 in step 10.  Every case also runs at Wb
640 under the stub's random fiber orders, where a warp that runs ahead of
its edge or walk values reads stale ones, and at widths that are no
multiple of 128 (1, 100, 129), where the last chunk and the last group of
4 lanes are partial; levels 3-6 run at 100 and 129 under random orders
too.
"""
import ctypes

import pytest
import torch

from winnowmap_tpu_torch.tools import check as PC
from winnowmap_tpu_torch.tools import cuda_stub
from winnowmap_tpu_torch.tools import probe_bisect as P1
from winnowmap_tpu_torch.tools import probe_core as P3
from winnowmap_tpu_torch.tools import probe_l0 as P2

torch.set_num_threads(1)

B, WB, ROWS, KR = 4, 128, 32, 4
FILL = 0x5A


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if cuda_stub.gxx_path() is None:
        pytest.skip("needs g++ to build the CUDA sources against the stub "
                    "runtime")
    lib = cuda_stub.load("probes.cu", tmp_path_factory.mktemp("cuda_stub_p"))
    lib.cuda_stub_schedule.argtypes = [ctypes.c_ulonglong]
    return lib


def _filled(*ts):
    for t in ts:
        if t is not None:
            t.fill_(FILL)


def _core(lib, level, dirs_mode, s32, Wb=WB, KR=KR, seed=0):
    """The source's core kernel and core_plain on small_inputs (`seed`:
    the stub's random order): equal outputs; returns the plain res."""
    qbuf, qlen = PC.small_inputs("cpu", B=B, Wb=Wb, ROWS=ROWS, KR=KR)
    kw = dict(Wb=Wb, ROWS=ROWS, KR=KR, dirs_mode=dirs_mode, s32=s32)
    work_p = torch.zeros((B, 2), dtype=torch.int64)
    res_p, dirs_p, st_p = P3.core_plain(level, qbuf, qlen, work=work_p, **kw)
    res, dirs, st = P3.core_outputs(qbuf, Wb, ROWS, KR, dirs_mode, s32)
    work = torch.empty_like(work_p)
    _filled(res, dirs, st, work)
    lib.cuda_stub_schedule(seed)
    try:
        assert P3.core_launch(lib, level, dirs_mode, s32, qbuf, qlen, res,
                              dirs, st, work, Wb, ROWS, KR, None) == 0
    finally:
        lib.cuda_stub_schedule(0)
    assert torch.equal(res, res_p)
    assert torch.equal(st, st_p)
    assert torch.equal(work, work_p)
    if level >= 3 and dirs_mode != "none":
        assert torch.equal(dirs, dirs_p)
    return res_p


CORE = PC.core_cases()
CORE_IDS = [f"L{lv}-{dm}{'-s32' * s}" for lv, dm, s in CORE]


@pytest.mark.parametrize("level,dirs_mode,s32", CORE, ids=CORE_IDS)
def test_core_source_matches_plain(lib, level, dirs_mode, s32):
    """Every level under every dirs mode and the int32 state at level 6,
    Wb 128, 4 steps of 32 rows."""
    res = _core(lib, level, dirs_mode, s32)
    if level in (4, 5):
        assert res[0, 3] == 1  # job 0's last step walks the frozen state


@pytest.mark.parametrize("level,dirs_mode,s32", CORE, ids=CORE_IDS)
def test_core_source_five_warps_every_case(lib, level, dirs_mode, s32):
    """Every case at Wb 640 (five warps and their edge exchange), 4 steps,
    under a random fiber order of its own."""
    res = _core(lib, level, dirs_mode, s32, Wb=640,
                seed=1 + CORE.index((level, dirs_mode, s32)))
    if level in (4, 5):
        assert res[0, 3] == 1


# level 6 at the timed depth (63 steps, 2,016 rows): the timed jobs (2-3)
# set done at row 293 with their chunks' tails written ahead only in part
WIDE = [(1, "none", False, 2), (3, "i32", False, 2), (4, "u8", False, 4),
        (6, "u8", False, 11), (6, "i32", False, 11), (6, "u8", True, 11),
        (6, "u8", False, 63), (6, "i32", False, 63)]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("level,dirs_mode,s32,kr", WIDE,
                         ids=[f"L{lv}-{dm}{'-s32' * s}-kr{kr}"
                              for lv, dm, s, kr in WIDE])
def test_core_source_wide_matches_plain(lib, level, dirs_mode, s32, kr,
                                        seed):
    """Wb 640, five warps with their edge exchange, in the stub's own order
    and a random one; at level 6 the timed jobs set done in step 10."""
    res = _core(lib, level, dirs_mode, s32, Wb=640, KR=kr, seed=seed)
    if level == 4:
        assert res[0, 3] == 1
    if level == 6:
        assert res[2:, 3].tolist() == [1, 1]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("level,dirs_mode,kr", [(6, "u8", 11), (4, "i32", 4),
                                                (2, "u8", 2)])
def test_core_source_five_warps_any_schedule(lib, level, dirs_mode, kr,
                                             seed):
    """The five-warp launch at Wb 640 under random fiber orders: the edge
    array, the walk's exchange and the frozen state are read only after
    the barrier that orders their writes."""
    _core(lib, level, dirs_mode, False, Wb=640, KR=kr, seed=seed)


# widths that are no multiple of 128: one lane, a partial first chunk whose
# rows keep 4-lane groups aligned, a partial second chunk with a partial
# last group (a store a lane), and the full window
PARTIAL = [(lv, dm, s) for lv, dm, s in CORE
           if dm != "none" or lv in (0, 1, 2)]


@pytest.mark.parametrize("Wb", [1, 100, 129, 640])
@pytest.mark.parametrize("level,dirs_mode,s32", PARTIAL,
                         ids=[f"L{lv}-{dm}{'-s32' * s}"
                              for lv, dm, s in PARTIAL])
def test_core_source_any_width_matches_plain(lib, level, dirs_mode, s32,
                                             Wb):
    """Wb of 1, 100, 129 and 640 (partial last chunk and group), 4 steps
    of 32 rows, in the stub's own order: every output equal to core_plain,
    the unwritten fill included."""
    _core(lib, level, dirs_mode, s32, Wb=Wb)


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("Wb", [100, 129])
@pytest.mark.parametrize("level,dirs_mode,s32",
                         [(3, "u8", False), (5, "i32", False),
                          (6, "u8", False), (6, "i32", False),
                          (6, "u8", True)],
                         ids=["L3-u8", "L5-i32", "L6-u8", "L6-i32",
                              "L6-u8-s32"])
def test_core_source_any_width_any_schedule(lib, level, dirs_mode, s32, Wb,
                                            seed):
    """Partial widths under random fiber orders: at Wb 100 the one warp's
    chunk ends inside a 4-lane group; at Wb 129 a second warp holds one
    lane, so the edge exchange, the walk and the after-done zero rows are
    read only after the barrier that orders their writes."""
    _core(lib, level, dirs_mode, s32, Wb=Wb, seed=seed)


# the wide launch (above 640 lanes): a warp a chunk of 128 lanes, its
# buffers in a scratch slot a job; at 5000 lanes 40 chunks on 32 warps, so
# warps 0-7 take two chunks each in turn, their state kept in the slot
@pytest.mark.parametrize("dirs_mode", ["u8", "i32"])
@pytest.mark.parametrize("Wb", PC.WIDE_WIDTHS)
def test_core_source_wide_launch_level6(lib, Wb, dirs_mode):
    """Level 6 at Wb 641, 1000, 2048, 4096 and 5000 (a partial sixth and
    eighth chunk, 16 and 32 whole chunks, 40 chunks on 32 warps), 4 steps
    of 32 rows: every output equal to core_plain."""
    _core(lib, 6, dirs_mode, False, Wb=Wb)


@pytest.mark.parametrize("level,dirs_mode,s32", CORE, ids=CORE_IDS)
def test_core_source_wide_launch_every_case(lib, level, dirs_mode, s32):
    """Every case at Wb 5000 (warps taking two chunks in turn), 4 steps,
    under a random fiber order of its own; job 0 sets done at levels 4-5
    and its last step walks the frozen state."""
    res = _core(lib, level, dirs_mode, s32, Wb=5000,
                seed=31 + CORE.index((level, dirs_mode, s32)))
    if level in (4, 5):
        assert res[0, 3] == 1


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("level,dirs_mode,s32,Wb",
                         [(6, "u8", False, 2048), (6, "i32", False, 5000),
                          (6, "u8", True, 4096), (5, "i32", False, 1000)],
                         ids=["L6-u8-2048", "L6-i32-5000", "L6-u8-s32-4096",
                              "L5-i32-1000"])
def test_core_source_wide_launch_after_done(lib, level, dirs_mode, s32, Wb,
                                            seed):
    """11 steps: the timed jobs (2-3) set done at level 6 in step 10, so
    the wide launch's frozen walk and zero rows run, in the stub's order
    and a random one."""
    res = _core(lib, level, dirs_mode, s32, Wb=Wb, KR=11, seed=seed)
    if level == 6:
        assert res[2:, 3].tolist() == [1, 1]


def test_core_source_refuses_a_short_scratch(lib):
    """The wide launch refuses a scratch smaller than B slots."""
    Wb = 1000
    qbuf, qlen = PC.small_inputs("cpu", B=B, Wb=Wb, ROWS=ROWS, KR=2)
    res, dirs, st = P3.core_outputs(qbuf, Wb, ROWS, 2, "u8", False)
    per_job = P3.scratch_bytes(lib, 6, False, Wb)
    assert per_job > 0 and P3.scratch_bytes(lib, 6, False, 640) == 0
    scratch = torch.empty(B * per_job - 1, dtype=torch.uint8)
    assert lib.wm_probe_core_launch(
        6, 1, 0, qbuf.data_ptr(), qbuf.shape[1], qlen.data_ptr(),
        res.data_ptr(), dirs.data_ptr(), st.data_ptr(), None, B, Wb, ROWS,
        2, scratch.data_ptr(), scratch.numel(), None) != 0


@pytest.mark.parametrize("Wb", [128, 640, 130])
@pytest.mark.parametrize("name,kv", P2.cases, ids=[n.strip()
                                                   for n, _ in P2.cases])
def test_l0_source_matches_plain(lib, name, kv, Wb):
    """Every P2 case, at word rows (Wb 128, 640) and with a partial last
    word (Wb 130, byte stores)."""
    _, qlen = PC.small_inputs("cpu", B=B)
    kw = dict(nstate=kv.get("nstate", 7), touch=kv.get("touch", True),
              read_acc=kv.get("read_acc", True))
    KR_ = kv.get("KR", 3)
    res_p, st_p = P2.l0_plain(qlen, Wb=Wb, KR=KR_, **kw)
    res, st = P2.l0_outputs(qlen, kw["nstate"], Wb)
    _filled(res, st)
    assert P2.l0_launch(lib, res, st, kw["touch"], kw["read_acc"], KR_,
                        None) == 0
    assert torch.equal(res, res_p)
    assert torch.equal(st, st_p)


@pytest.mark.parametrize("tag,body,kv", P1.variants,
                         ids=[t.strip() for t, _, _ in P1.variants])
def test_bisect_source_matches_plain(lib, tag, body, kv):
    """Every P1 body at the small shape (Wb 128, ROWS 32, 3 steps)."""
    _, qlen = PC.small_inputs("cpu", B=B)
    with_dirs = kv.get("with_dirs", True)
    res_p, dirs_p, st_p = P1.bisect_plain(body, qlen, Wb=WB, ROWS=ROWS, KR=3,
                                          with_dirs=with_dirs)
    res, dirs, st = P1.bisect_outputs(qlen, WB, ROWS, 3, with_dirs)
    _filled(res, st)
    if dirs is not None:
        dirs.zero_()  # rows the body does not write are 0 in the plain
    assert P1.bisect_launch(lib, body, res, dirs, st, ROWS, 3, None) == 0
    assert torch.equal(res, res_p)
    assert torch.equal(st, st_p)
    if body is P1.dirs_store:
        assert torch.equal(dirs, dirs_p)
