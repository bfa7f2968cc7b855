"""File driver (map/pipeline.py map_file, _write_read): the window's time
outside map_batch calls (parsing, longest-first sorting, SAM formatting
and writing), as a share of the window, from the benchmark's spans."""


def read(rec):
    s = rec.get("spans", {}).get("map_batch")
    if s is None or rec["window_s"] <= 0:
        return None
    return 100.0 * (rec["window_s"] - s) / rec["window_s"]
