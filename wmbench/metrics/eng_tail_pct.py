"""Engine host (native wm_engine.cpp): the engine threads' time done with
their phase while others still ran (the phase's tail),
STATS["eng_finished_s"], as a share of their thread time,
STATS["eng_thread_s"]."""


def read(rec):
    st = rec.get("stats", {})
    if "eng_finished_s" not in st or not st.get("eng_thread_s"):
        return None
    return 100.0 * st["eng_finished_s"] / st["eng_thread_s"]
