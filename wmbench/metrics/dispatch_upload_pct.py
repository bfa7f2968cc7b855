"""Dispatch (extend/kernels.DevCallPooled): the host-to-device copies of a
call's jobs, offsets, column counts and junction bytes before its DP's
launch, the program's span dispatch_upload (a pageable copy first waits
for the stream's earlier work), as a share of the window."""


def read(rec):
    v = rec.get("stats", {}).get("dispatch_upload_s")
    if v is None or rec["window_s"] <= 0:
        return None
    return 100.0 * v / rec["window_s"]
