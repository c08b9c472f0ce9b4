"""Median host ms per case of the program's window.case span: the
sliding window's whole dispatch of one volume (staging, patch batches,
label map enqueued), over the device-only stretch's cases.
Read from the program's own records (perfbench/spans.py)."""

from perfbench import spans


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return spans.median(rec, ["window.case"])
