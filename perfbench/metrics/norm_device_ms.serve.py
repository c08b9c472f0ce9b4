"""Device ms per case of the operations launched inside the pb.norm ranges
(the norm modules of models/layers.py)."""

from perfbench.profiling import sum_ranges


def read(rec):
    if rec.get("kind") != "serve":
        return None
    device = sum_ranges(rec, ["norm"])
    if device <= 0:
        return None
    return 1e3 * device / rec["ranged_items"]
