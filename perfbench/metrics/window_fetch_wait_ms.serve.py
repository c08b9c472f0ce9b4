"""Median host ms per case of the program's window.fetch span: the D2H
copy of a case's label map, which waits for its device work, over the
device-only stretch's cases.
Read from the program's own records (perfbench/spans.py)."""

from perfbench import spans


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return spans.median(rec, ["window.fetch"])
