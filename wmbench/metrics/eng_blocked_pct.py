"""Engine host (native wm_engine.cpp): the engine threads' time waiting on
an exported DP job or chain, STATS["eng_blocked_s"], as a share of their
thread time, STATS["eng_thread_s"] (threads x each phase's wall)."""


def read(rec):
    st = rec.get("stats", {})
    if "eng_blocked_s" not in st or not st.get("eng_thread_s"):
        return None
    return 100.0 * st["eng_blocked_s"] / st["eng_thread_s"]
