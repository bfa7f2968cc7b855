"""Each cell's controls are data in its traffic mix (`controls`): a
control's `options` break one guarantee its configuration states, a
fault (wmbench/faults/<fault>.py) breaks the timed path underneath, and
`fails` names the number that has to go over its limit.  The readings at
each cell's own size come from wmbench/control.py on the card; here the
files are checked and one control runs on the CPU at a test size."""
import json

import pytest

from wmbench import core
from conftest import ROOT, tiny_base

MAN = core.load_manifest(ROOT)
CELLS = sorted(w["name"] for w in MAN["workloads"])


def _cell(name):
    return core.find_cell(MAN, name)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_controls_its_files_name(cell):
    _, _, cfg, _, mix = _cell(cell)
    limits = dict(cfg["limits"], **mix["limits"])
    assert mix["controls"] and "options" in mix["controls"][0]
    for c in mix["controls"]:
        assert c["fails"] in limits, c
        assert ("options" in c) != ("fault" in c), c
        if "fault" in c:
            assert (ROOT / "wmbench" / "faults" / f"{c['fault']}.py").is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_options_change_what_they_name(cell):
    _, _, cfg, _, mix = _cell(cell)
    _, sound = core.set_options(cfg, mix)
    for c in mix["controls"]:
        if "options" not in c:
            continue
        _, ctl = core.set_options(cfg, mix, c["options"])
        for k, v in c["options"].items():
            assert core.option_value(ctl, k) == v
            assert core.option_value(sound, k) != v


def test_set_options_refuses_what_it_does_not_apply():
    _, _, cfg, _, mix = _cell("ont-r9.wgs")
    with pytest.raises(ValueError):
        core.set_options(dict(cfg, flags=["-a", "--frag"]), mix)
    with pytest.raises(KeyError):
        core.set_options(dict(cfg, scoring=dict(cfg["scoring"], qq=1)), mix)
    with pytest.raises(KeyError):
        core.set_options(cfg, mix, {"MM_F_NO_SUCH_FLAG": True})
    with pytest.raises(ValueError):
        core.set_options(dict(cfg, scoring=dict(cfg["scoring"], q=5)), mix)


def test_a_new_control_is_found_by_name_alone(tmp_path):
    man, base = tiny_base(tmp_path, "ont-r9.wgs")
    path = base / "traffic" / "ont-r9-wgs.json"
    mix = json.loads(path.read_text())
    mix["controls"].append({"name": "bw-50", "options": {"bw": 50},
                            "fails": "clipped_pct"})
    path.write_text(json.dumps(mix))
    _, _, cfg, _, mix = core.find_cell(man, "ont-r9.wgs", base)
    _, mo = core.set_options(cfg, mix,
                             core.find_control(mix, "bw-50")["options"])
    assert mo.bw == 50


def test_the_control_is_not_correct_on_the_cpu(tmp_path):
    man, base = tiny_base(tmp_path, "ont-r9.wgs")
    _, _, _, _, mix = core.find_cell(man, "ont-r9.wgs", base)
    ctl = mix["controls"][0]
    out = core.run(man, "ont-r9.wgs", 20261018, 0.1, False, device="cpu",
                   base=base, log=lambda s: None, control=ctl)
    assert not out["correct"]
    c = out["check"][ctl["fails"]]
    assert c["value"] > c["limit"]
