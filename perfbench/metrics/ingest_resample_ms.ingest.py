"""Median host ms per case of the program's ingest.resample spans: the
cropped volume zoomed to the configured shape, over the device-only
stretch's cases.
Read from the program's own records (perfbench/spans.py)."""

from perfbench import spans


def read(rec):
    if rec.get("kind") != "ingest":
        return None
    return spans.median(rec, ["ingest.resample"])
