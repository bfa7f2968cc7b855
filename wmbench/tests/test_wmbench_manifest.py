"""BENCHMARK.json's names and units, the metric readers' arithmetic, and
that a new configuration, mix or metric is found by name alone."""
import json
import re
import shutil
from pathlib import Path

import pytest

from wmbench import core, roofline

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return core.load_manifest(ROOT)


def test_names_and_units_use_allowed_characters(manifest):
    names = [c["name"] for c in manifest["configs"]]
    names += [w["name"] for w in manifest["workloads"]]
    names += [w["traffic"] for w in manifest["workloads"]]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in manifest["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), names
    for text in ([c["why"] for c in manifest["configs"]]
                 + [w["why"] for w in manifest["workloads"]]
                 + [m["layer"] for m in manifest["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text


def test_every_cell_reports_what_the_contract_asks(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for w in manifest["workloads"]:
        ends = [m["name"] for m in core.cell_metrics(manifest, w["name"],
                                                      False)]
        assert "setup_s" in ends and len(ends) >= 2
        per = core.cell_metrics(manifest, w["name"], True)
        assert per
        for m in per:
            assert m["moves"] in ends
            assert (ROOT / "wmbench" / "metrics" /
                    f"{m['name']}.py").exists()
        core.find_cell(manifest, w["name"])  # its files are there


def test_metric_readers_arithmetic():
    rec = {"window_s": 20.0, "bases": 50_000_000,
           "spans": {"map_batch": 18.0, "build_index": 9.5},
           "stats": {"eng_chain_s": 100.0, "dev_jobs": 3000.0,
                     "dev_calls": 12.0, "dev_wait_s": 2.0},
           "busy_s": 5.0, "trace_window_s": 20.0,
           "kernels": {"extd": {"device_s": 0.01, "cells": 1e9,
                                "bytes": 1.2e9, "calls": 3},
                       "exts": {"device_s": 0.0, "cells": 0.0,
                                "bytes": 0.0, "calls": 0}}}
    got = {n: core.metric_reader(n)(rec) for n in (
        "driver_host_pct", "index_build_s", "eng_chain_cpu_s_per_Mbp",
        "jobs_per_call", "dev_wait_pct", "extd_roofline",
        "exts_roofline", "device_idle_pct")}
    assert got["driver_host_pct"] == pytest.approx(10.0)
    assert got["index_build_s"] == 9.5
    assert got["eng_chain_cpu_s_per_Mbp"] == pytest.approx(2.0)
    assert got["jobs_per_call"] == pytest.approx(250.0)
    assert got["dev_wait_pct"] == pytest.approx(10.0)
    # 1e9 cells x 47 operations at 16.73e12 a second: 2.809 ms of 10 ms
    assert got["extd_roofline"] == pytest.approx(
        100 * 1e9 * 47 / (132 * 64 * 1.98e9) / 0.01)
    assert got["extd_roofline"] == pytest.approx(28.09, abs=0.01)
    assert got["exts_roofline"] is None  # nothing to read: no value
    assert got["device_idle_pct"] == pytest.approx(75.0)
    empty = {"window_s": 1.0, "bases": 1}
    assert all(core.metric_reader(n)(empty) is None for n in (
        "driver_host_pct", "index_build_s", "eng_chain_cpu_s_per_Mbp",
        "jobs_per_call", "dev_wait_pct", "extd_roofline",
        "device_idle_pct"))


def test_roofline_bound_picks_the_larger_side():
    t, side = roofline.bound_s("exts", 1e6, 1.0)
    assert side == "operations" and t == pytest.approx(
        1e6 * 38 / 16.73e12, rel=1e-3)
    t, side = roofline.bound_s("extd", 1.0, 3.35e9)
    assert side == "bytes" and t == pytest.approx(1e-3)
    assert list(roofline.live_cells([10, 5], [20, 5], [3, 100], False)) \
        == [29 * 4, 9 * 5]
    assert list(roofline.live_cells([10], [20], [3], True)) == [29 * 10]


def test_new_files_are_found_by_name_alone(manifest, tmp_path):
    base = tmp_path / "wmbench"
    shutil.copytree(ROOT / "wmbench" / "configs", base / "configs")
    shutil.copytree(ROOT / "wmbench" / "traffic", base / "traffic")
    shutil.copytree(ROOT / "wmbench" / "metrics", base / "metrics")
    cfg = json.loads((base / "configs" / "hs250-map-ont.json").read_text())
    cfg["name"] = "hs100-map-pb"
    (base / "configs" / "hs100-map-pb.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "ont-r9-wgs.json").read_text())
    mix["errors"] = {"sub": 0.001, "ins": 0.0, "del": 0.0}
    (base / "traffic" / "hifi-wgs.json").write_text(json.dumps(mix))
    (base / "metrics" / "new_share_pct.py").write_text(
        "def read(rec):\n    return 100.0 * rec['x']\n")
    man = json.loads(json.dumps(manifest))
    man["configs"].append({"name": "hs100-map-pb", "source": "x",
                           "file": "wmbench/configs/hs100-map-pb.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "hifi.wgs", "config": "hs100-map-pb",
                             "traffic": "hifi-wgs", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "new_share_pct", "unit": "%",
                             "better": "lower", "source": "program_span",
                             "layer": "file driver",
                             "moves": "input_Mbp_per_s",
                             "workloads": ["hifi.wgs"]})
    w, centry, cfg2, cfile, mix2 = core.find_cell(man, "hifi.wgs", base)
    assert cfg2["name"] == "hs100-map-pb" and mix2["errors"]["sub"] == 0.001
    names = [m["name"] for m in core.cell_metrics(man, "hifi.wgs", True)]
    assert names == ["new_share_pct"]
    assert core.metric_reader("new_share_pct", base)({"x": 0.5}) == 50.0
