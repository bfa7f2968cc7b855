"""How the port builds and launches without a card: the native library's
build through a temporary name, K3's launch geometry, and K1's and K4's
(their launch variants against the source, the ring span bound, and the
launch entry's layout check, run through the stub CUDA runtime)."""
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest

import winnowmap_tpu_torch.native as native
from winnowmap_tpu_torch.extend import kernels as K


def test_native_build_replaces_a_whole_library(tmp_path, monkeypatch):
    """g++ writes a per-process temporary name; the cached name appears
    only once the library is whole, so a second process (pytest-xdist's
    workers) that finds it never loads a half-written file."""
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    seen = {}
    real_run = subprocess.run

    def fake_run(cmd, *a, **kw):
        if "-o" not in cmd:  # the compiler's version, for the fingerprint
            return real_run(["true"], *a, **kw)
        out = cmd[cmd.index("-o") + 1]
        seen["target"] = out
        with open(out, "wb") as f:
            f.write(b"\x7fELF half")
            seen["cached_mid_write"] = seen["cached"].exists()
            f.write(b" and the rest")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(native.subprocess, "run", fake_run)
    cached = seen["cached"] = native._lib_path()
    assert native._build() == cached
    assert seen["target"] != str(cached)
    assert seen["cached_mid_write"] is False
    assert cached.read_bytes() == b"\x7fELF half and the rest"
    assert sorted(p.name for p in tmp_path.iterdir()) == [cached.name]


# (cap, qlen_max) -> (threads, slots a thread, ring, path): the bands of
# chip_smoke.py's phase 2 (256 spliced jobs, bands up to ~830 lanes: cap
# 1024) and the spread of phase 5's calls (a few short jobs up to long
# extensions), and the large-band path of the long unbanded job (cap 16384)
K3_GEOMETRY = [
    (128, 90, (256, 1, 256, "reg256x1")),
    (256, 200, (256, 1, 256, "reg256x1")),
    (512, 450, (512, 1, 512, "reg512x1")),
    (1024, 830, (512, 2, 1024, "reg512x2")),
    (2048, 1900, (512, 4, 2048, "reg512x4")),
    (4096, 4000, (512, 0, 4096, "mem-smem")),
    (8192, 8000, (512, 0, 8192, "mem-smem")),
    (16384, 8700, (512, 0, 16384, "mem-global")),
]


@pytest.mark.parametrize("cap,qlen,want", K3_GEOMETRY,
                         ids=[str(c[0]) for c in K3_GEOMETRY])
def test_exts_geometry(cap, qlen, want):
    """K3's launch: the threads follow the band up to 512, a thread keeps
    1-4 ring slots in registers, and rings no register variant holds take
    the large-band path (state in shared memory up to K3_SMEM_MAX, else
    global scratch).  Shared bytes: the row exchange, the warp-edge
    carries, the staged query, and the memory path's state."""
    g = K.exts_geometry(cap, qlen)
    assert (g.threads, g.spt, g.ring, g.path) == want
    assert g.ring >= cap and g.ring & (g.ring - 1) == 0
    assert g.qstage == (qlen + 15) // 16 * 16
    xch = 2 * (32 * 16 + 16)  # per row: 32 warp maxima and four ints
    edges = 2 * (g.ring // 32) * 8
    mem = 13 * g.ring if g.spt == 0 else 0
    if g.mem_smem or g.spt:
        assert g.smem == xch + edges + g.qstage + mem and g.scratch == 0
    else:
        assert g.smem == xch + edges + g.qstage and g.scratch == mem
    assert g.smem <= K.K3_SMEM_MAX


@pytest.mark.parametrize("cap", [64 << k for k in range(10)])
def test_exts_geometry_launch_is_compiled(cap):
    """Every band takes a launch that csrc/exts.cu compiles: a register
    variant whose ring holds the band, or the memory path."""
    g = K.exts_geometry(cap, 100)
    assert g.ring >= cap
    if g.spt:
        assert g.spt in K.K3_VARIANTS[g.threads]
        assert g.ring == g.threads * g.spt
    else:
        assert g.threads == K.K3_MEM_THREADS
    assert (g.threads, g.spt) in _compiled_launches()


def _compiled_launches():
    """The (threads, slots) pairs of exts.cu's WM_K3_VARIANTS."""
    src = (Path(K.__file__).parent.parent / "csrc" / "exts.cu").read_text()
    line = next(ln for ln in src.splitlines()
                if ln.startswith("#define WM_K3_VARIANTS"))
    return {(int(a), int(b))
            for a, b in re.findall(r"X\((\d+), (\d+)\)", line)}


def test_exts_variants_match_the_source():
    """kernels.K3_VARIANTS and the memory path's threads are exactly the
    launches exts.cu instantiates."""
    want = {(nt, s) for nt, spts in K.K3_VARIANTS.items() for s in spts}
    assert _compiled_launches() == want | {(K.K3_MEM_THREADS, 0)}


def test_exts_geometry_limits(monkeypatch):
    """A query above K3_QSTAGE_MAX is read from the pool (qstage capped);
    with no register variant any band takes the memory path, its state in
    shared memory up to K3_SMEM_MAX."""
    g = K.exts_geometry(1024, K.K3_QSTAGE_MAX + 100)
    assert g.qstage == K.K3_QSTAGE_MAX
    monkeypatch.setattr(K, "K3_VARIANTS", {})
    g = K.exts_geometry(1024, 830)
    assert (g.threads, g.spt, g.ring, g.mem_smem) == (512, 0, 1024, True)
    monkeypatch.setattr(K, "K3_SMEM_MAX", 0)
    g = K.exts_geometry(1024, 830)
    assert (g.path, g.scratch) == ("mem-global", 13 * 1024)


# (span, qlen_max) -> (threads, slots a thread, ring, path): the bands of
# chip_smoke.py's phase 2 (512 jobs of 1000 bp at w = 500: span 545, a
# ring of 640; the ragged batch's w = 751 and full bands of up to 1500
# bp) and of short engine jobs, and the memory path of long full bands
EXT_GEOMETRY = [
    (49, 30, (128, 1, 128, "reg128x1")),
    (113, 300, (128, 1, 128, "reg128x1")),
    (193, 400, (128, 2, 256, "reg128x2")),
    (337, 600, (128, 3, 384, "reg128x3")),
    (449, 900, (128, 4, 512, "reg128x4")),
    (545, 1000, (128, 5, 640, "reg128x5")),
    (801, 1500, (128, 7, 896, "reg128x7")),
    (1024, 1500, (128, 8, 1024, "reg128x8")),
    (1025, 1500, (512, 0, 1536, "mem-smem")),
    (8449, 8700, (512, 0, 8704, "mem-smem")),
    (16833, 16800, (512, 0, 16896, "mem-global")),
]


@pytest.mark.parametrize("span,qlen,want", EXT_GEOMETRY,
                         ids=[str(c[0]) for c in EXT_GEOMETRY])
def test_ext_geometry(span, qlen, want):
    """K1's and K4's launch: 128 threads keep ceil(span / 128) slots each
    in registers up to 8, the ring their 128 x slots lanes; wider spans
    take the memory path at 512 threads, the ring the multiple of 512 that
    holds the span (state in shared memory up to EXT_SMEM_MAX, else global
    scratch).  Shared bytes: the row exchange, the warp-edge carries, the
    staged query, and the memory path's state (three words a slot)."""
    g = K.ext_geometry(span, qlen)
    assert (g.threads, g.spt, g.ring, g.path) == want
    assert span <= g.ring < span + g.threads and g.ring % g.threads == 0
    assert g.qstage == (qlen + 15) // 16 * 16
    xch = 2 * (32 * 16 + 16)  # per row: 32 warp maxima and four ints
    edges = 2 * (g.ring // 32) * 8
    mem = 12 * g.ring if g.spt == 0 else 0
    if g.mem_smem or g.spt:
        assert g.smem == xch + edges + g.qstage + mem and g.scratch == 0
    else:
        assert g.smem == xch + edges + g.qstage and g.scratch == mem
    assert g.smem <= K.EXT_SMEM_MAX


def _ext_variants_in_source():
    """The (threads, slots) pairs of ext_common.cuh's WM_EXT_VARIANTS (a
    macro continued over lines)."""
    src = (Path(K.__file__).parent.parent / "csrc"
           / "ext_common.cuh").read_text()
    macro = re.search(r"#define WM_EXT_VARIANTS\(X\)((?:.*\\\n)*.*)",
                      src).group(1)
    return {(int(a), int(b))
            for a, b in re.findall(r"X\((\d+), (\d+)\)", macro)}


def test_ext_variants_match_the_source():
    """kernels.EXT_VARIANTS and the memory path's threads are exactly the
    launches ext_common.cuh instantiates, and every span takes one."""
    want = {(nt, s) for nt, spts in K.EXT_VARIANTS.items() for s in spts}
    assert _ext_variants_in_source() == want | {(K.EXT_MEM_THREADS, 0)}
    for span in list(range(1, 1200, 7)) + [1 << k for k in range(16)]:
        g = K.ext_geometry(span, 100)
        assert (g.threads, g.spt) in _ext_variants_in_source()
        assert g.spt == 0 or g.ring == g.threads * g.spt


def test_ext_geometry_limits(monkeypatch):
    """A query above EXT_QSTAGE_MAX is read from the pool (qstage capped);
    with no register variant any span takes the memory path, its state in
    shared memory up to EXT_SMEM_MAX."""
    assert K.ext_geometry(600, K.EXT_QSTAGE_MAX + 100).qstage == \
        K.EXT_QSTAGE_MAX
    monkeypatch.setattr(K, "EXT_VARIANTS", {})
    g = K.ext_geometry(200, 400)
    assert (g.threads, g.spt, g.ring, g.path) == (512, 0, 512, "mem-smem")
    monkeypatch.setattr(K, "EXT_SMEM_MAX", 0)
    g = K.ext_geometry(200, 400)
    assert (g.path, g.scratch) == ("mem-global", 12 * 512)


def _row_spans(ql, tl, w):
    """Every row's ring lanes [last_st - 1, max(en, g + 15)] as K1 and K4
    walk them (csrc/ext_common.cuh), up to the first empty row."""
    out, last_st = [], 0
    for r in range(ql + tl - 1):
        st0 = max(0, r - ql + 1, (r - w + 1) >> 1)
        en0 = min(tl - 1, r, (r + w) >> 1)
        if st0 > en0:
            break
        st, en = st0 // 16 * 16, (en0 + 16) // 16 * 16 - 1
        g = st0 + (en0 - st0) // 16 * 16
        out.append(max(en, g + 15) - (last_st - 1) + 1)
        last_st = st
    return out


def test_ring_span_bound():
    """kernels.ring_span bounds the lanes of every row of random banded
    jobs (and is reached within 16 lanes), so JobGeometry.span and the
    ring ext_geometry makes of it hold every row; the main path's jobs
    (1000 x 1000 bp, w = 500) touch more than 512 lanes and take a ring of
    640."""
    rng = np.random.default_rng(3)
    worst = 0
    for _ in range(300):
        ql, tl = (int(x) for x in rng.integers(1, 700, 2))
        w = int(rng.choice([-1, 0, 1, 15, 16, 33, 64, 97, 200, 500]))
        ja = np.array([[0, ql, 0, 0, tl, 0, w, 400]], np.int64)
        geo = K.job_geometry(ja)
        w_eff = int(geo.w_eff[0])
        spans = _row_spans(ql, tl, w_eff)
        band = min(ql, tl, w_eff + 1)
        assert max(spans) <= K.ring_span(band) == geo.span
        assert K.ext_geometry(geo.span, ql).ring >= max(spans)
        worst = max(worst, max(spans) - int(K.ring_span(band)))
    assert worst > -16
    ja = np.array([[0, 1000, 0, 0, 1000, 0, 500, 400]], np.int64)
    geo = K.job_geometry(ja)
    assert max(_row_spans(1000, 1000, 500)) > 512
    assert K.ext_geometry(geo.span, 1000).ring == 640


@pytest.fixture(scope="module")
def stub_extd(tmp_path_factory):
    from winnowmap_tpu_torch.tools import cuda_stub

    if cuda_stub.gxx_path() is None:
        pytest.skip("needs g++ to build the CUDA sources against the stub "
                    "runtime")
    return cuda_stub.load("extd.cu", tmp_path_factory.mktemp("cuda_stub"))


def test_ext_launch_refuses_a_foreign_layout(stub_extd):
    """K1's launch entry (built against the stub runtime) checks the ring,
    shared and scratch bytes it is given against its own layout, and
    launches nothing when they differ; the right layout launches."""
    import dataclasses

    import torch

    from winnowmap_tpu_torch.extend import check
    from winnowmap_tpu_torch.map.align import gen_simple_mat

    rng = np.random.default_rng(1)
    qp, tp, jobs, _, _ = check.random_jobs(rng, [60, 90], 33, 200)
    c = check.OnDevice("cpu", qp, tp, jobs, gen_simple_mat(2, 4, 1),
                       (4, 2, 24, 1), 0x18, 0)
    res = torch.full((2, 16), 7, dtype=torch.int32)
    dirs = torch.zeros(c.geo.dirs_bytes, dtype=torch.uint8)
    g = c.ext

    def launch(geo):
        return K.ext_launch(stub_extd, "extd", geo, c.prof, c.flag, c.qpool,
                            c.tpool, c.jobs, c.off, dirs, res, None)

    for bad in (dataclasses.replace(g, smem=g.smem + 16),
                dataclasses.replace(g, scratch=g.scratch + 12),
                dataclasses.replace(g, ring=g.ring * 2),
                dataclasses.replace(g, spt=3)):
        assert launch(bad) != 0
    assert (res == 7).all()
    assert launch(g) == 0
    assert torch.equal(res[:, :9], c.k1_plain()[0][:, :9])


def _constexpr(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_chain_ring_reach_matches_the_source():
    """chain.device.RING_REACH is csrc/chain.cu's kReach, its ring of
    anchors less the one being walked."""
    from winnowmap_tpu_torch.chain import device as CD

    src = (Path(K.__file__).parent.parent / "csrc" / "chain.cu").read_text()
    assert CD.RING_REACH == _constexpr(src, "kRing") - 1
    assert "constexpr int kReach = kRing - 1;" in src


@pytest.mark.parametrize("k,plan", [(1, (1, 2)), (15, (4, 8)),
                                    (16, (4, 8)), (19, (5, 8)),
                                    (31, (8, 8)), (32, (8, 8))])
def test_kcount_plan_matches_the_source(k, plan):
    """kcount.device's tile, widest digit and counter words are
    csrc/kcount.cu's, and its passes of equal digits at k: ceil(2k / 8)
    passes (k = 15: four of 8 bits)."""
    from winnowmap_tpu_torch.kcount import device as KD

    src = (Path(K.__file__).parent.parent / "csrc" / "kcount.cu").read_text()
    threads = _constexpr(src, "kThreads")
    assert KD.KC_TILE == threads // 32 * 32 * _constexpr(src, "kRounds")
    assert KD.KC_MAX_BITS == _constexpr(src, "kMaxBits")
    assert KD.KC_CTR_WORDS == _constexpr(src, "kCtrWords")
    assert KD.kc_plan(k) == plan
