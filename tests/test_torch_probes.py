"""The port's cost probes (winnowmap_tpu_torch/tools) against the JAX
package's Pallas probes (tests/tools/probe_{core,l0,bisect}.py), run in
Pallas interpret mode on the CPU without editing them.

P3: probe_core.build's kernel is wrapped in a pallas_call with run_level's
specs and interpret=True, and a last-step copy of its VMEM state to an
output.  P1 and P2 build their kernels inside run(), so pallas_call is
patched to add interpret=True and jax.jit to record the jitted function's
outputs; P1's step bodies, local to its main(), are collected by running
main() with run() replaced, and are also run in a pallas_call of run()'s
layout that exports the state.  P2's state is held to its closed form.
Same numpy inputs on both sides; integer code, so every comparison is
exact.  The kernels themselves are checked against the plain versions on
the card (tests/test_torch_gpu.py, chip_smoke.py phase 7).
"""
import contextlib
import functools
import io
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from winnowmap_tpu_torch import tools
from winnowmap_tpu_torch.tools import probe_bisect as P1
from winnowmap_tpu_torch.tools import probe_core as P3
from winnowmap_tpu_torch.tools import probe_l0 as P2

sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
import probe_bisect as J1  # noqa: E402
import probe_core as J3  # noqa: E402
import probe_l0 as J2  # noqa: E402

# P3's small shape: ROWS 4 (a multiple of 4 for the packed dirs)
B, WB, ROWS, KR = 8, 128, 4, 3
# P3 at 96 rows, jobs 0-3 of qlen 1, 2, 3 and 9 (seed 5): at levels 4-6
# a job sets done (its walk falls 400 below its maximum once the band has
# passed it), and its band is cut after that
DONE_KR, DONE_SEED = 24, 5


def _inputs(B=B, Wb=WB, ROWS=ROWS, KR=KR, seed=20261016):
    rng = np.random.default_rng(seed)
    qbuf = rng.integers(0, 4, (B, Wb + 384)).astype(np.uint8)
    qlen = rng.integers(1, KR * ROWS + 8, (B, 1)).astype(np.int32)
    return qbuf, qlen


def _jax_core(level, qbuf, qlen, dirs_mode, s32, KR=KR):
    """probe_core.build's kernel under run_level's specs, interpreted, its
    7 state arrays copied to an output after the last step (run_level
    keeps them in VMEM scratch).  Returns (res, dirs or None, state)."""
    TB = qbuf.shape[0]
    QR = WB + 256
    sdt = jnp.int32 if s32 else jnp.int8
    inner = J3.build(level, TB, WB, ROWS, KR, dirs_mode=dirs_mode, s32=s32)
    n_out = 1 if dirs_mode == "none" else 2

    def kernel(qbuf_ref, qlen_ref, *rest):
        outs, st_ref, scr = rest[:n_out], rest[n_out], rest[n_out + 1:]
        inner(qbuf_ref, qlen_ref, *outs, *scr)

        @pl.when(pl.program_id(1) == KR - 1)
        def _state():
            for i, ref in enumerate(scr[:7]):
                st_ref[i] = ref[:]

    if dirs_mode == "none":
        dirs_spec, dirs_shape = [], []
    elif dirs_mode == "i32":
        dirs_spec = [pl.BlockSpec((ROWS // 4, TB, WB), lambda b, r: (r, b, 0))]
        dirs_shape = [jax.ShapeDtypeStruct((KR * ROWS // 4, TB, WB),
                                           jnp.int32)]
    else:
        dirs_spec = [pl.BlockSpec((ROWS, TB, WB), lambda b, r: (r, b, 0))]
        dirs_shape = [jax.ShapeDtypeStruct((KR * ROWS, TB, WB), jnp.uint8)]
    f = pl.pallas_call(
        kernel, grid=(1, KR),
        in_specs=[pl.BlockSpec((TB, QR + 128), lambda b, r: (b, 0)),
                  pl.BlockSpec((TB, 1), lambda b, r: (b, 0))],
        out_specs=(pl.BlockSpec((TB, 16), lambda b, r: (b, 0)), *dirs_spec,
                   pl.BlockSpec((7, TB, WB), lambda b, r: (0, b, 0))),
        out_shape=(jax.ShapeDtypeStruct((TB, 16), jnp.int32), *dirs_shape,
                   jax.ShapeDtypeStruct((7, TB, WB), sdt)),
        scratch_shapes=[pltpu.VMEM((TB, WB), sdt)] * 7
        + [pltpu.VMEM((TB, 16), jnp.int32)],
        interpret=True)
    out = [np.asarray(x) for x in f(qbuf, qlen)]
    return out[0], (out[1] if dirs_mode != "none" else None), out[-1]


def _assert_core_equal(level, qbuf, qlen, dirs_mode, s32, KR=KR):
    res_j, dirs_j, st_j = _jax_core(level, qbuf, qlen, dirs_mode, s32, KR=KR)
    res, dirs, state = P3.core_plain(
        level, torch.from_numpy(qbuf), torch.from_numpy(qlen), Wb=WB,
        ROWS=ROWS, KR=KR, dirs_mode=dirs_mode, s32=s32)
    assert np.array_equal(res.numpy(), res_j)
    if level >= 3 and dirs_mode != "none":  # below level 3 dirs are unset
        assert np.array_equal(dirs.numpy(), dirs_j)
    assert state.dtype == (torch.int32 if s32 else torch.int8)
    assert np.array_equal(state.numpy(), st_j)
    return res_j


CORE_CASES = [(lv, dm, False) for lv in range(7) for dm in P3.DIRS_MODES] + [
    (0, "u8", True), (6, "u8", True)]


@pytest.mark.parametrize("level,dirs_mode,s32", CORE_CASES,
                         ids=[f"L{c[0]}-{c[1]}{'-s32' * c[2]}"
                              for c in CORE_CASES])
def test_core_plain_matches_jax_probe(level, dirs_mode, s32):
    res_j = _assert_core_equal(level, *_inputs(), dirs_mode, s32)
    if level >= 4:
        assert res_j[:, :3].any()  # the walk ran
    if level == 6:
        assert len({tuple(r) for r in res_j[:, :4].tolist()}) > 1


@pytest.mark.parametrize("level", (4, 5, 6), ids=lambda lv: f"L{lv}")
def test_core_done_matches_jax_probe(level):
    """The z-drop stop: a job sets done, and its band is cut from then on."""
    qbuf, qlen = _inputs(KR=DONE_KR, seed=DONE_SEED)
    qlen[:4, 0] = [1, 2, 3, 9]
    res_j = _assert_core_equal(level, qbuf, qlen, "u8", False, KR=DONE_KR)
    assert res_j[:, 3].any()


def _interpreted(run, *args, **kw):
    """Calls a JAX probe's run() with pallas_call interpreted; returns
    the outputs of the function run() jits, as numpy arrays."""
    outs = []
    real_call, real_jit = pl.pallas_call, jax.jit

    def jit(f, *a, **k):
        jf = real_jit(f, *a, **k)

        def recorded(*args):
            out = jf(*args)
            outs.append(out)
            return out
        return recorded

    with mock.patch.object(pl, "pallas_call", lambda *a, **k: real_call(
            *a, **{**k, "interpret": True})), \
            mock.patch.object(jax, "jit", jit):
        run(*args, **kw)
    out = outs[-1]
    if isinstance(out, (tuple, list)):
        return [np.asarray(x) for x in out]
    return [np.asarray(out)]


@functools.lru_cache(maxsize=None)
def _jax_bodies():
    """P1's (tag, body, kwargs) from its main(), run() replaced."""
    got = []
    with mock.patch.object(J1, "run", lambda tag, body, **kv: got.append(
            (tag, body, kv))), mock.patch.object(sys, "argv", ["p"]):
        J1.main()
    return got


def _jax_bisect(body, B, Wb, ROWS, KR, with_dirs=True):
    """probe_bisect.run's kernel around a P1 body, interpreted, with the 7
    scratch arrays copied to an output after the last step (run() keeps
    them in VMEM).  Returns (res, dirs or None, state)."""
    i8, i32 = jnp.int8, jnp.int32

    def kernel(qlen_ref, res_ref, *rest):
        rest = list(rest)
        dirs_ref = rest.pop(0) if with_dirs else None
        st_ref = rest.pop(0)
        scr, acc_s = rest[:-1], rest[-1]
        k = pl.program_id(1)

        @pl.when(k == 0)
        def _init():
            for ref in scr:
                ref[:] = jnp.zeros((B, Wb), i8)
            acc_s[:] = jnp.zeros((B, 16), i32)

        body(jnp, pl, k, scr, acc_s, dirs_ref, qlen_ref)

        @pl.when(k == KR - 1)
        def _out():
            res_ref[:] = acc_s[:]
            for i, ref in enumerate(scr):
                st_ref[i] = ref[:]

    dirs_spec = ([pl.BlockSpec((ROWS, B, Wb), lambda b, r: (r, b, 0))]
                 if with_dirs else [])
    dirs_shape = ([jax.ShapeDtypeStruct((KR * ROWS, B, Wb), jnp.uint8)]
                  if with_dirs else [])
    f = pl.pallas_call(
        kernel, grid=(1, KR),
        in_specs=[pl.BlockSpec((B, 1), lambda b, r: (b, 0))],
        out_specs=(pl.BlockSpec((B, 16), lambda b, r: (b, 0)), *dirs_spec,
                   pl.BlockSpec((P1.N_SCR, B, Wb), lambda b, r: (0, b, 0))),
        out_shape=(jax.ShapeDtypeStruct((B, 16), i32), *dirs_shape,
                   jax.ShapeDtypeStruct((P1.N_SCR, B, Wb), i8)),
        scratch_shapes=[pltpu.VMEM((B, Wb), i8)] * P1.N_SCR
        + [pltpu.VMEM((B, 16), i32)],
        interpret=True)
    out = [np.asarray(x) for x in f(np.full((B, 1), 1000, np.int32))]
    return out[0], (out[1] if with_dirs else None), out[-1]


@pytest.mark.parametrize("i", range(len(P1.variants)),
                         ids=[v[0].strip() for v in P1.variants])
def test_bisect_plain_matches_jax_probe(i):
    tag, jbody, kv = _jax_bodies()[i]
    ptag, body, pkv = P1.variants[i]
    assert tag == ptag and jbody.__name__ == body.__name__ and kv == pkv
    Bs, Wb, ROWS1, KR1 = 8, 128, 32, 2
    out = _interpreted(J1.run, tag, jbody, B=Bs, TB=Bs, Wb=Wb, ROWS=ROWS1,
                       KR=KR1, reps=0, **kv)
    res_j, dirs_j, st_j = _jax_bisect(jbody, Bs, Wb, ROWS1, KR1, **kv)
    qlen = torch.full((Bs, 1), 1000, dtype=torch.int32)
    res, dirs, state = P1.bisect_plain(body, qlen, Wb=Wb, ROWS=ROWS1,
                                       KR=KR1, **pkv)
    # the state-exporting harness is run()'s: same res and dirs
    assert np.array_equal(res_j, out[0])
    assert np.array_equal(res.numpy(), out[0])
    assert np.array_equal(state.numpy(), st_j)
    if body is P1.dirs_store:  # the only body that writes dirs
        assert np.array_equal(dirs_j, out[1])
        assert np.array_equal(dirs.numpy(), out[1])
    if body in (P1.rw_astype, P1.rw_i8, P1.rw_loop32, P1.rolls):
        assert st_j.any()  # the body changed the state


def _jax_cases():
    """P2's (name, kwargs) from its main(), run() replaced."""
    got = []
    buf = io.StringIO()
    with mock.patch.object(J2, "run", lambda **kv: (got.append(kv),
                                                     (1.0, 1.0))[1]), \
            contextlib.redirect_stdout(buf):
        J2.main()
    names = [line.split(":")[0].strip() for line in
             buf.getvalue().splitlines()]
    return list(zip(names, got))


J2_CASES = _jax_cases()


def test_l0_cases_are_the_tpu_scripts_without_tb():
    """The port's cases are the TPU script's, less the four TB cases, which
    repeat others here (no tile height)."""
    want = [(n, kv) for n, kv in J2_CASES if "TB" not in kv]
    assert [(n.strip(), kv) for n, kv in P2.cases] == want
    assert len(want) == len(J2_CASES) - 4


@pytest.mark.parametrize("i", range(len(J2_CASES)),
                         ids=[c[0] for c in J2_CASES])
def test_l0_plain_matches_jax_probe(i):
    kv = J2_CASES[i][1]
    port_kv = {k: v for k, v in kv.items() if k != "TB"}
    assert port_kv in [c[1] for c in P2.cases]
    small = {k: v for k, v in kv.items() if k not in ("TB", "KR")}
    Bs, Wb, KR2 = 8, 128, 3
    out = _interpreted(J2.run, **small, B=Bs, TB=Bs, Wb=Wb, KR=KR2, reps=0)
    qlen = torch.full((Bs, 1), 1000, dtype=torch.int32)
    res, state = P2.l0_plain(
        qlen, nstate=kv.get("nstate", 7), Wb=Wb, KR=KR2,
        touch=kv.get("touch", True), read_acc=kv.get("read_acc", True))
    assert np.array_equal(res.numpy(), out[0])
    if kv.get("touch", True) and kv.get("read_acc", True):
        assert (out[0] == KR2).all()
    if kv.get("touch", True) and kv.get("nstate", 7):
        assert (state[0] == KR2).all() and not state[1:].any()


def test_wrappers_run_plain_on_cpu_tensors():
    """On CPU tensors each wrapper runs its plain version and launches
    nothing."""
    qbuf, qlen = (torch.from_numpy(x) for x in _inputs())
    n0 = dict(tools.LAUNCHES)
    kw = dict(Wb=WB, ROWS=ROWS, KR=KR, dirs_mode="i32")
    work = torch.zeros((B, 2), dtype=torch.int64)
    for got, want in zip(P3.core_probe(6, qbuf, qlen, work=work, **kw),
                         P3.core_plain(6, qbuf, qlen, **kw)):
        assert torch.equal(got, want)
    assert (work[:, 1] <= KR * ROWS).all() and (work[:, 0] > 0).all()
    for got, want in zip(P2.l0_probe(qlen, nstate=3, Wb=WB, KR=KR),
                         P2.l0_plain(qlen, nstate=3, Wb=WB, KR=KR)):
        assert torch.equal(got, want)
    for got, want in zip(P1.bisect_probe(P1.rolls, qlen, Wb=WB, KR=KR),
                         P1.bisect_plain(P1.rolls, qlen, Wb=WB, KR=KR)):
        assert torch.equal(got, want)
    assert tools.LAUNCHES == n0


def test_entry_points_need_a_card_unless_asked_for_cpu():
    """device=None means the card: without one every entry point raises;
    device='cpu' times the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: P3.run_level(6), lambda: P3.main([]),
                 lambda: P2.run(), lambda: P2.main([]),
                 lambda: P1.run("empty", P1.empty), lambda: P1.main([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    o = P3.run_level(6, B=2, Wb=WB, ROWS=ROWS, KR=KR, device="cpu")
    assert o["device"] == "cpu" and "ns_per_row" not in o and o["ms"] > 0
    assert P2.run(nstate=1, B=2, Wb=WB, KR=KR, device="cpu")["ms"] > 0
    assert P1.run("rolls", P1.rolls, B=2, TB=1, Wb=WB, KR=KR,
                  device="cpu")["ms"] > 0


def test_bad_shapes_raise():
    qbuf, qlen = (torch.from_numpy(x) for x in _inputs())
    with pytest.raises(ValueError, match="ROWS % 4"):
        P3.core_plain(3, qbuf, qlen, Wb=WB, ROWS=6, KR=1, dirs_mode="i32")
    with pytest.raises(ValueError, match="qbuf"):
        P3.core_plain(3, qbuf[:, :WB], qlen, Wb=WB, ROWS=4, KR=1)
    with pytest.raises(ValueError, match="ROWS >= 32"):
        P1.bisect_plain(P1.dirs_store, qlen, Wb=WB, ROWS=16, KR=1)
