"""device.span, the mapping path's spans and the engine's thread-time
counters on the CPU: a span adds its host seconds to STATS["<name>_s"]
and, only while a torch profiler records, is the range "wm.<name>" nested
under its caller's; after map_batch_engine (the kernels' plain versions)
and map_file every span the path reaches is in STATS, the inner spans fit
in the outer ones, and the engine's blocked and finished thread time fit
in its thread time."""
import re
import threading
import time
from collections import defaultdict
from pathlib import Path

import pytest
import torch

from test_torch_multidev import _genome_and_reads, _setup

torch.set_num_threads(1)

PKG = Path(__file__).resolve().parent.parent / "winnowmap_tpu_torch"
# the spans map_batch_engine reaches on the CPU with the chain exchange on
# (collect_sync waits on a CUDA event: a card's only)
ENGINE_SPANS = ("eng_setup", "eng_launch", "eng_step", "eng_group",
                "chain_dev", "dispatch", "dispatch_upload", "dispatch_bonus",
                "dev_wait", "collect_decode", "eng_deliver", "eng_results")


def _profiled_ranges(fn):
    """{range name: [its innermost enclosing wm. range's name, or None]} of
    the wm. ranges recorded while fn runs under a CPU profiler (read from
    the profiler's raw events: building its event tree takes minutes)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    evs = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("wm.")]
    out = defaultdict(list)
    for i, (s, e, name) in enumerate(evs):
        around = [(pe - ps, pn) for j, (ps, pe, pn) in enumerate(evs)
                  if j != i and ps <= s and e <= pe]
        out[name].append(min(around)[1] if around else None)
    return out


def test_span_accumulates_seconds_and_nests():
    from winnowmap_tpu_torch.device import span

    c = defaultdict(float)
    t0 = time.perf_counter()
    with span(c, "outer"):
        with span(c, "inner"):
            time.sleep(0.02)
        time.sleep(0.01)
    wall = time.perf_counter() - t0
    assert set(c) == {"outer_s", "inner_s"}
    assert 0.02 <= c["inner_s"] < c["outer_s"] <= wall
    first = c["inner_s"]
    with span(c, "inner"):
        time.sleep(0.01)
    assert c["inner_s"] >= first + 0.01


def test_span_counts_an_exception_and_lets_it_pass():
    from winnowmap_tpu_torch.device import span

    c = defaultdict(float)
    with pytest.raises(KeyError):
        with span(c, "fails"):
            raise KeyError("x")
    assert c["fails_s"] > 0


def test_span_ranges_nest_under_the_profiler():
    from winnowmap_tpu_torch.device import span

    c = defaultdict(float)

    def work():
        with span(c, "outer"):
            for _ in range(2):
                with span(c, "inner"):
                    torch.ones(4).sum()

    ranges = _profiled_ranges(work)
    assert ranges["wm.outer"] == [None]
    assert ranges["wm.inner"] == ["wm.outer", "wm.outer"]


def test_span_opens_no_range_without_a_profiler(monkeypatch):
    from winnowmap_tpu_torch.device import span

    opened = []
    real = torch.profiler.record_function

    def record(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", record)
    c = defaultdict(float)
    with span(c, "quiet"):
        pass
    assert opened == [] and c["quiet_s"] >= 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span(c, "loud"):
            pass
    assert opened == ["wm.loud"]


def test_span_counts_exactly_under_threads(monkeypatch):
    """Eight threads time 200 spans each into one counter, on a clock that
    reads each span's exit exactly 1.0 after its enter: the total is 1600,
    so no update is lost."""
    import sys
    import types

    from winnowmap_tpu_torch import device

    ticks = threading.local()

    def clock():
        ticks.t = getattr(ticks, "t", 0.0) + 1.0
        return ticks.t

    monkeypatch.setattr(device, "time", types.SimpleNamespace(
        perf_counter=clock))
    c = defaultdict(float)

    def worker():
        for _ in range(200):
            with device.span(c, "x"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert c["x_s"] == 8 * 200


def test_stats_is_one_object_everywhere():
    from winnowmap_tpu_torch import device
    from winnowmap_tpu_torch.map import batch, engine

    assert engine.STATS is device.STATS and batch.STATS is device.STATS


@pytest.fixture(scope="module")
def engine_stats():
    """STATS of one map_batch_engine run of four short reads on the CPU,
    every chain through the chain exchange (chain_min 1)."""
    from winnowmap_tpu_torch.map.engine import STATS, map_batch_engine

    gstr, reads, names = _genome_and_reads(4, (300, 700), seed=11)
    mi, mo = _setup("winnowmap_tpu_torch", gstr)
    STATS.clear()
    res = map_batch_engine(mi, mo, reads, names, torch.device("cpu"),
                           chain_min=1)
    assert all(r.regs for r in res)
    return dict(STATS)


@pytest.mark.parametrize("name", ENGINE_SPANS)
def test_engine_path_reaches_its_span(engine_stats, name):
    assert engine_stats[name + "_s"] > 0


def test_engine_spans_fit_in_their_callers(engine_stats):
    st = engine_stats
    assert (st.get("collect_sync_s", 0.0) + st["collect_decode_s"]
            <= st["dev_wait_s"])
    assert st["dispatch_upload_s"] + st["dispatch_bonus_s"] <= st["dispatch_s"]
    assert st["dev_calls"] > 0 and st["chain_dev_jobs"] > 0


def test_engine_thread_time(engine_stats):
    st = engine_stats
    assert st["eng_thread_s"] > 0
    assert st["eng_blocked_s"] > 0 and st["eng_finished_s"] >= 0
    assert st["eng_blocked_s"] + st["eng_finished_s"] <= st["eng_thread_s"]


@pytest.mark.parametrize("key", ["cells_live_G", "cells_pad_G",
                                 "eng_host_dp_s"])
def test_removed_counters_stay_away(engine_stats, key):
    from winnowmap_tpu_torch.map import engine

    assert key not in engine_stats
    assert not hasattr(engine, "_est_live_cells")
    assert engine_stats["eng_host_dp_calls"] == 0


def test_engine_perf_readout_slots():
    """wm_eng_perf's slots 4-6 are the thread, blocked and finished
    nanoseconds of the phases run so far; slots 0 and 7 stay 0."""
    import ctypes

    import numpy as np

    from winnowmap_tpu_torch.extend.kernels import PoolContext
    from winnowmap_tpu_torch.map.engine import MapEngine, build_read_pool

    gstr, reads, names = _genome_and_reads(2, (300, 700), seed=3)
    mi, mo = _setup("winnowmap_tpu_torch", gstr)
    qpool, qoffs = build_read_pool(reads)
    pools = PoolContext(qpool, mi, torch.device("cpu"))
    eng = MapEngine(mi, mo, reads, names, pools, qoffs, qpool, 0)
    try:
        perf = np.full(8, -1, np.int64)
        eng.L.wm_eng_perf(eng.h, perf.ctypes.data_as(ctypes.c_void_p))
        assert perf[4:].tolist() == [0, 0, 0, 0]
        eng.L.wm_eng_start_phase1(eng.h)
        eng._drive_phase()
        eng.L.wm_eng_perf(eng.h, perf.ctypes.data_as(ctypes.c_void_p))
        thread, blocked, finished, zero = perf[4:].tolist()
        assert thread > 0 and zero == 0 and perf[0] == 0
        assert 0 <= blocked and 0 <= finished
        assert blocked + finished <= thread
    finally:
        eng.close()


def test_engine_ranges_nest_under_the_profiler():
    """Under a CPU profiler the pump's ranges sit where the work is:
    dispatch_upload and dispatch_bonus inside dispatch, collect_decode
    inside dev_wait."""
    from winnowmap_tpu_torch.map.engine import map_batch_engine

    gstr, reads, names = _genome_and_reads(1, (300, 400), seed=7)
    mi, mo = _setup("winnowmap_tpu_torch", gstr)
    ranges = _profiled_ranges(lambda: map_batch_engine(
        mi, mo, reads, names, torch.device("cpu"), chain_min=1))
    assert set(ranges["wm.dispatch_upload"]) == {"wm.dispatch"}
    assert set(ranges["wm.dispatch_bonus"]) == {"wm.dispatch"}
    assert set(ranges["wm.dispatch"]) == {"wm.eng_group"}
    assert set(ranges["wm.collect_decode"]) == {"wm.dev_wait"}
    assert set(ranges["wm.eng_deliver"]) == {None}
    for name in ("eng_setup", "eng_launch", "eng_step", "chain_dev",
                 "eng_results"):
        assert ranges["wm." + name], name


def test_map_file_driver_spans(tmp_path):
    from winnowmap_tpu_torch.map.pipeline import map_file
    from winnowmap_tpu_torch.options import MM_F_OUT_SAM

    gstr, reads, names = _genome_and_reads(3, (300, 600), seed=13)
    mi, mo = _setup("winnowmap_tpu_torch", gstr)
    mo.flag |= MM_F_OUT_SAM
    fa = tmp_path / "reads.fa"
    fa.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), s)
                            for n, s in zip(names, reads)))
    from winnowmap_tpu_torch.device import STATS

    STATS.clear()
    with open(tmp_path / "out.sam", "w") as out:
        assert map_file(mi, mo, str(fa), out, device="cpu") == 3
    assert STATS["driver_read_s"] > 0 and STATS["driver_write_s"] > 0
    assert STATS["eng_setup_s"] > 0
    assert (tmp_path / "out.sam").read_text().count("\n") >= 3


def test_generator_path_spans():
    """The generator path's dispatch and wait are the same spans, and its
    gen_py_s stays the block's time less them."""
    from winnowmap_tpu_torch.device import STATS
    from winnowmap_tpu_torch.map.batch import map_batch_generator

    gstr, reads, names = _genome_and_reads(2, (300, 500), seed=17)
    mi, mo = _setup("winnowmap_tpu_torch", gstr)
    STATS.clear()
    t0 = time.perf_counter()
    res = map_batch_generator(mi, mo, reads, names, device="cpu")
    wall = time.perf_counter() - t0
    assert len(res) == 2
    st = dict(STATS)
    assert st["dispatch_s"] > 0 and st["dev_wait_s"] > 0
    assert st["dispatch_upload_s"] <= st["dispatch_s"]
    assert st["collect_decode_s"] <= st["dev_wait_s"]
    assert st["gen_py_s"] > 0
    assert st["gen_py_s"] + st["dispatch_s"] + st["dev_wait_s"] <= wall


@pytest.mark.parametrize("module", ["map/engine.py", "map/batch.py"])
def test_no_bare_timer_pairs_left(module):
    """Every timer of the pump is a span: no perf_counter pair is left."""
    src = (PKG / module).read_text()
    assert not re.search(r"perf_counter|import time\b", src)


def test_time_span_tool_reports_both_cases():
    """The tool's timing of 200 spans with the profiler off and on: both
    positive, and the ranges really recorded in the second case."""
    from winnowmap_tpu_torch.device import span
    from winnowmap_tpu_torch.tools.time_span import span_ns

    assert span_ns(span, 200) > 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert span_ns(span, 200) > 0
    assert sum(e.name() == "wm.x"
               for e in prof.profiler.kineto_results.events()) == 5 * 200
