"""How the port builds and launches without a card: the native library's
build through a temporary name, and K3's launch geometry."""
import re
import subprocess
from pathlib import Path

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
