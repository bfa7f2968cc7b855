"""The readers of the metrics that read the program's own spans and engine
counters, on hand-built records (and nothing on a program without them),
and program_gaps' labelling of idle gaps on a hand-built trace."""
from types import SimpleNamespace

import pytest

from wmbench import core, program_gaps

NEW = ("driver_io_pct", "eng_step_wait_pct", "eng_blocked_pct",
       "eng_tail_pct", "dispatch_upload_pct", "collect_decode_pct")


def test_program_span_readers_arithmetic():
    rec = {"window_s": 50.0, "bases": 100_000_000,
           "stats": {"driver_read_s": 1.0, "driver_write_s": 1.5,
                     "eng_step_s": 20.0, "eng_thread_s": 1000.0,
                     "eng_blocked_s": 300.0, "eng_finished_s": 150.0,
                     "dispatch_upload_s": 2.0, "collect_decode_s": 5.0,
                     "dev_wait_s": 6.0},
           "spans": {"map_batch": 45.0}}
    got = {n: core.metric_reader(n)(rec) for n in NEW}
    assert got == pytest.approx({
        "driver_io_pct": 5.0, "eng_step_wait_pct": 40.0,
        "eng_blocked_pct": 30.0, "eng_tail_pct": 15.0,
        "dispatch_upload_pct": 4.0, "collect_decode_pct": 10.0})
    # the nesting the acceptance compares
    assert got["collect_decode_pct"] <= core.metric_reader(
        "dev_wait_pct")(rec)
    assert got["driver_io_pct"] <= core.metric_reader(
        "driver_host_pct")(rec)


def test_program_span_readers_give_nothing_without_the_spans():
    """The parent's program has none of the keys: every reader returns
    None, as does one whose engine ran no phase."""
    parent = {"window_s": 50.0, "bases": 1,
              "stats": {"dev_wait_s": 6.0, "dispatch_s": 3.0}}
    assert all(core.metric_reader(n)(parent) is None for n in NEW)
    idle = dict(parent, stats={"eng_thread_s": 0.0, "eng_blocked_s": 0.0,
                               "eng_finished_s": 0.0})
    assert core.metric_reader("eng_blocked_pct")(idle) is None
    assert core.metric_reader("eng_tail_pct")(idle) is None


def test_new_metrics_are_declared_for_every_cell():
    man = core.load_manifest()
    cells = [w["name"] for w in man["workloads"]]
    per = {m["name"]: m for m in man["per_layer"]}
    layers = {"driver_io_pct": "file driver",
              "eng_step_wait_pct": "engine host",
              "eng_blocked_pct": "engine host",
              "eng_tail_pct": "engine host",
              "dispatch_upload_pct": "dispatch",
              "collect_decode_pct": "pump and collect"}
    for n in NEW:
        m = per[n]
        assert (m["layer"], m["unit"], m["better"], m["moves"]) == (
            layers[n], "%", "lower", "input_Mbp_per_s")
        assert m["workloads"] == cells


class _Ev:
    def __init__(self, name, s, e, card=False, act="cpu_op"):
        self._n, self._s, self._d = name, s, e - s
        self._card, self._act = card, act

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._card else "DeviceType.CPU"

    def activity_type(self):
        return self._act

    def is_user_annotation(self):
        return self._act == "gpu_user_annotation"


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_program_gaps_label_each_gap_by_its_innermost_range():
    """A window of 100 s (in ns units): kernels at 10-20 and 60-70; gaps
    0-10 (map_file only), 20-60 (map_batch, wm.eng_step inside
    wm.eng_results around its midpoint 40), 70-100 (collect,
    wm.collect_decode inside wm.dev_wait)."""
    s = 10 ** 9
    ev = [_Ev("wmbench.window", 0, 100 * s),
          _Ev("wmbench.map_file", 0, 100 * s),
          _Ev("wmbench.map_batch", 10 * s, 100 * s),
          _Ev("wmbench.collect", 70 * s, 100 * s),
          _Ev("wm.eng_results", 30 * s, 50 * s),
          _Ev("wm.eng_step", 35 * s, 45 * s),
          _Ev("wm.eng_step", 35 * s, 45 * s, card=True,
              act="gpu_user_annotation"),
          _Ev("wm.dev_wait", 70 * s, 100 * s),
          _Ev("wm.collect_decode", 80 * s, 95 * s),
          _Ev("k1", 10 * s, 20 * s, card=True, act="kernel"),
          _Ev("memcpy", 60 * s, 70 * s, card=True, act="gpu_memcpy")]
    got = program_gaps.idle_by_span(_prof(ev))
    assert got["gaps"] == {"engine_host/eng_step": [40.0, 40.0],
                           "collect/collect_decode": [30.0, 30.0],
                           "driver": [10.0, 10.0]}
    assert got["named_pct"] == {"engine_host": 100.0, "collect": 100.0,
                                "driver": 0.0}
    assert got["unnamed"] == {"-..eng_results": 10.0}
    assert got["wm_ranges"] == 4


def test_program_gaps_without_program_ranges_keep_the_benchmarks_labels():
    s = 10 ** 9
    ev = [_Ev("wmbench.window", 0, 10 * s),
          _Ev("wmbench.map_batch", 0, 10 * s),
          _Ev("k1", 4 * s, 6 * s, card=True, act="kernel")]
    got = program_gaps.idle_by_span(_prof(ev))
    assert got["gaps"] == {"engine_host": [8.0, 4.0]}
    assert got["named_pct"] == {"engine_host": 0.0}
    assert got["unnamed"] == {"-..-": 8.0}
    assert got["wm_ranges"] == 0


def test_innermost_range_sweep():
    ranges = [(0, 100, "a"), (10, 20, "b"), (30, 40, "c"), (32, 35, "d")]
    assert program_gaps._innermost(ranges, [5, 15, 25, 33, 38, 150]) == [
        "a", "b", "a", "d", "c", None]
