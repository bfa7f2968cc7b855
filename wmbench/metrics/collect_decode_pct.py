"""Pump and collect (extend/kernels.DevCallPooled.collect_blob): the host's
decode of a call's results after its event has synchronised (buffer views,
the CIGARs' run-length encoding, reach), the program's span
collect_decode, as a share of the window."""


def read(rec):
    v = rec.get("stats", {}).get("collect_decode_s")
    if v is None or rec["window_s"] <= 0:
        return None
    return 100.0 * v / rec["window_s"]
