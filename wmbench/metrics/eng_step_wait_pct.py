"""Engine host (map/engine.py MapEngine._step, _service_chains): the
pump's time blocked in wm_eng_step and wm_eng_step_chains until the
engine's live threads settle, the program's span eng_step, as a share of
the window."""


def read(rec):
    v = rec.get("stats", {}).get("eng_step_s")
    if v is None or rec["window_s"] <= 0:
        return None
    return 100.0 * v / rec["window_s"]
