"""The PyTorch/CUDA port stands alone: no module of winnowmap_tpu_torch (nor
chip_smoke.py) imports jax or anything of the JAX package winnowmap_tpu.

A subprocess installs a sys.meta_path blocker for both, imports every module
of the port and runs one tiny DevCallPooled on the CPU, extd and spliced,
and one k-mer count through the block path (KC's plain version); an
AST scan of the sources finds no such import statement.  No module reads a
WM_* environment variable beyond the engine's thread count, the native
library's sanitizer build and the log level: the port has no switch that
routes work elsewhere.
"""
import ast
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "winnowmap_tpu_torch"
BLOCKED = ("jax", "jaxlib", "winnowmap_tpu")


def _port_modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


SCRIPT = textwrap.dedent("""
    import importlib, sys
    BLOCKED = {blocked!r}

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            root = name.split(".")[0]
            if root in BLOCKED:
                raise ImportError(f"blocked import of {{name}}")
            return None

    sys.meta_path.insert(0, Blocker())
    sys.path.insert(0, {repo!r})
    for m in {mods!r}:
        importlib.import_module(m)
    import numpy as np
    import torch
    from winnowmap_tpu_torch.extend.kernels import DevCallPooled, PoolContext
    from winnowmap_tpu_torch.index.build import MinimizerIndex
    from winnowmap_tpu_torch.map.align import gen_simple_mat
    rng = np.random.default_rng(0)
    t = rng.integers(0, 4, 80).astype(np.uint8)
    q = t.copy()
    q[::9] = (q[::9] + 1) % 4
    mi = MinimizerIndex(w=10, k=15, codes=t)
    pools = PoolContext(q, mi, torch.device("cpu"))
    jobs = np.array([[0, 80, 0, 0, 80, 0, 40, 100]], np.int64)
    res9, blob, off, ln, reach = DevCallPooled(
        pools, jobs, gen_simple_mat(2, 4, 1), 4, 2, 24, 1, 0, 0x0
    ).collect_blob()
    assert res9[0, 8] > 0 and ln[0] > 0, (res9, ln)
    res9, blob, off, ln, reach = DevCallPooled(
        pools, jobs, gen_simple_mat(1, 2, 1), 2, 1, 32, 0, 0, 0x508,
        splice=(9, 9)).collect_blob()
    assert res9[0, 8] > 0 and ln[0] > 0, (res9, ln)
    from types import SimpleNamespace
    from winnowmap_tpu_torch.kcount import count_kmers
    kc = count_kmers([SimpleNamespace(seq=b"ACGTNACGTACGTAC" * 9)], 5,
                     device="cpu")
    assert kc.n_total == 86 and kc.n_distinct == 6, kc
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("PORT-STANDALONE-OK")
""")


def test_port_imports_without_jax_subprocess():
    script = SCRIPT.format(blocked=BLOCKED, repo=str(REPO),
                           mods=_port_modules())
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT-STANDALONE-OK" in proc.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_has_no_jax_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BLOCKED]
    assert not bad, f"{path}: imports {bad}"


def test_resolve_device_never_falls_back():
    import torch

    from winnowmap_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)


# the WM_* environment variables the port reads, by module: none of them
# chooses where a job runs
ENV_READS = {"cli.py": {"WM_ENGINE_THREADS"},
             "map/engine.py": {"WM_ENGINE_THREADS"},
             "native/__init__.py": {"WM_NATIVE_SAN"},
             "utils/log.py": {"WM_VERBOSE"}}
_ENV_READ = re.compile(
    r"(?:environ(?:\.get|\.setdefault|\.pop)?\s*[\[(]|getenv\s*\()\s*"
    r"[\"']([A-Za-z0-9_]+)[\"']")


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_reads_no_wm_switch(path):
    rel = path.relative_to(PKG).as_posix()
    names = {m for m in _ENV_READ.findall(path.read_text())
             if m.startswith("WM_")}
    assert names <= ENV_READS.get(rel, set()), f"{rel} reads {names}"
