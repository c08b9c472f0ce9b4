"""Share of the roofline the conv blocks reached, in %: the sum of
peaks.bound_ms over the forward's convs inside conv blocks (FLOPs and
bytes from perfbench/flops.py) over the device time of the operations
launched inside the pb.conv ranges, less that inside their pb.norm ranges,
whichever kernels ran there (cuDNN or the hand kernels)."""

from perfbench.profiling import sum_ranges


def read(rec):
    if rec.get("kind") != "train" or "conv_bound_s_per_item" not in rec:
        return None
    device = sum_ranges(rec, ["conv"]) - sum_ranges(rec, ["norm"])
    if device <= 0:
        return None
    return 100.0 * rec["conv_bound_s_per_item"] * rec["ranged_items"] / device

