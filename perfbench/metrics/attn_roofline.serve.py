"""Share of the roofline the window attention reached, in %: the sum of
peaks.bound_ms over the forward's operations of group "attn" (FLOPs and
bytes from the family's ops, perfbench/flops.py: the two matmuls over the
padded grid, and a fused kernel's bytes) over the device time of the
operations launched inside the pb.attn ranges (the program's
WindowAttention modules), whichever route ran there."""

from perfbench.profiling import sum_ranges


def read(rec):
    bound = rec.get("bound_s_per_item", {}).get("attn")
    if rec.get("kind") != "serve" or not bound:
        return None
    device = sum_ranges(rec, ["attn"])
    if device <= 0:
        return None
    return 100.0 * bound * rec["ranged_items"] / device
