"""Device ms per case of the operations launched inside the pb.attn
ranges (the program's WindowAttention modules: the attention in the
windows, with its bias where it is not cached)."""

from perfbench.profiling import sum_ranges


def read(rec):
    if rec.get("kind") != "serve":
        return None
    device = sum_ranges(rec, ["attn"])
    if device <= 0:
        return None
    return 1e3 * device / rec["ranged_items"]
