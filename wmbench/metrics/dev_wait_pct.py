"""Pump and collect (MapEngine._drive_phase, collect_blob): the host's
time blocked on the card, STATS["dev_wait_s"], as a share of the
window."""


def read(rec):
    v = rec.get("stats", {}).get("dev_wait_s")
    if v is None or rec["window_s"] <= 0:
        return None
    return 100.0 * v / rec["window_s"]
