"""Index build (index/build.py build_index -> sketch/device.py -> S1): the
seconds of the span around build_index in set-up."""


def read(rec):
    return rec.get("spans", {}).get("build_index")
