"""Engine host (map/engine.py MapEngine, native wm_engine.cpp): the
engine's own chaining counter, STATS["eng_chain_s"] (thread-seconds summed
over its threads), over the window's input Mbp."""


def read(rec):
    v = rec.get("stats", {}).get("eng_chain_s")
    if v is None or rec["bases"] <= 0:
        return None
    return v / (rec["bases"] / 1e6)
