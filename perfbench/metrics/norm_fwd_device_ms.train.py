"""Device ms per train step of the operations launched inside the pb.norm
ranges (the norm modules of models/layers.py) in the step's forward.
Forward only: autograd's backward launches run outside every module's
forward, so they sit in no range."""

from perfbench.profiling import sum_ranges


def read(rec):
    if rec.get("kind") != "train":
        return None
    device = sum_ranges(rec, ["norm"])
    if device <= 0:
        return None
    return 1e3 * device / rec["ranged_items"]
