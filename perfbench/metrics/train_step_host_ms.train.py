"""Median host ms per step of the program's train.step span: the host's
time to enqueue one whole train step, over the device-only stretch's
steps.
Read from the program's own records (perfbench/spans.py)."""

from perfbench import spans


def read(rec):
    if rec.get("kind") != "train":
        return None
    return spans.median(rec, ["train.step"])
