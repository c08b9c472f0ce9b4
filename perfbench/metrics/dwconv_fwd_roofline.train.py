"""Share of the roofline the depthwise convs reached in the train step's
forward, in %: the sum of peaks.bound_ms over the forward's operations of
group "dwconv" (FLOPs and bytes from the family's ops, perfbench/flops.py:
the input read, the output written and the weights; bf16 tensor-core peak,
so the bytes term bounds them) over the device time of the operations
launched inside the pb.dwconv ranges (the program's DepthwiseConv3d
modules), whichever route ran there. Forward only: autograd's backward
launches run outside every module's forward, so they sit in no range."""

from perfbench.profiling import sum_ranges


def read(rec):
    bound = rec.get("bound_s_per_item", {}).get("dwconv")
    if rec.get("kind") != "train" or not bound:
        return None
    device = sum_ranges(rec, ["dwconv"])
    if device <= 0:
        return None
    return 100.0 * bound * rec["ranged_items"] / device
