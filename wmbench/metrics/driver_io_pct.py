"""File driver (map/pipeline.py map_file): the program's own spans around
reading each batch (driver_read, FASTA parsing) and writing its records
(driver_write, SAM formatting and writing), as a share of the window."""


def read(rec):
    st = rec.get("stats", {})
    if "driver_read_s" not in st or "driver_write_s" not in st \
            or rec["window_s"] <= 0:
        return None
    return 100.0 * (st["driver_read_s"] + st["driver_write_s"]) \
        / rec["window_s"]
