"""Dispatch (MapEngine._dispatch -> extend/kernels.DevCallPooled): DP jobs
a device call, STATS["dev_jobs"] / STATS["dev_calls"] over the window."""


def read(rec):
    st = rec.get("stats", {})
    if not st.get("dev_calls"):
        return None
    return st["dev_jobs"] / st["dev_calls"]
