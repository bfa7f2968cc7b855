"""A run's correctness comes out false when the timed path is broken
underneath it: the harness's look for a card is skipped (device "cpu":
the port's kernels run as their plain versions) and the rest of a run is
driven at a small size.  The faults a mapping cell can have
(wmbench/faults/): half of a batch left out, an answer altered where it
is produced, and the extension DP run under another gap cost.  (A mapper
keeps no state from step to step, and one-card cells have no exchange
between chips, so those faults do not arise.)"""
import pytest

from wmbench import core
from conftest import tiny_base

FAULTS = [("half_batch", {}, "origin_miss_pct"),
          ("altered", {}, "record_faults"),
          ("dp_scoring", {"q": 8, "e": 4, "q2": 48, "e2": 2},
           "dp_score_deficit_pct")]


def _run(tmp_path, cell="ont-r9.wgs", control=None):
    man, base = tiny_base(tmp_path, cell)
    return core.run(man, cell, 20261018, 0.1, False, device="cpu",
                    base=base, log=lambda s: None, control=control)


def test_the_sound_path_is_correct(tmp_path):
    out = _run(tmp_path)
    assert out["correct"], out["check"]
    assert out["check"]["record_faults"]["value"] == 0


@pytest.mark.parametrize("fault,args,number", FAULTS)
def test_a_broken_path_is_not_correct(tmp_path, fault, args, number):
    out = _run(tmp_path, control={"name": fault, "fault": fault,
                                  "args": args})
    assert not out["correct"]
    c = out["check"][number]
    assert c["value"] > c["limit"]


def test_a_fault_is_undone_after_its_run(tmp_path):
    from winnowmap_tpu_torch.map import engine, pipeline
    before = (pipeline.map_batch, engine.DevCallPooled)
    _run(tmp_path, control={"name": "x", "fault": "dp_scoring",
                            "args": {"q": 8}})
    assert (pipeline.map_batch, engine.DevCallPooled) == before
