"""Share of the roofline the pointwise MLPs (1^3 conv, GELU, 1^3 conv)
reached in the train step's forward, in %: the sum of peaks.bound_ms over
the forward's operations of group "mlp" (FLOPs and bytes from the family's
ops, perfbench/flops.py: the two GEMMs; the bytes of a fused kernel, x
read and y written once and the weights, the wide intermediates not
counted) over the device time of the operations launched inside the pb.mlp
ranges (the program's PointwiseMLP modules), whichever route ran there.
Forward only: autograd's backward launches sit in no range."""

from perfbench.profiling import sum_ranges


def read(rec):
    bound = rec.get("bound_s_per_item", {}).get("mlp")
    if rec.get("kind") != "train" or not bound:
        return None
    device = sum_ranges(rec, ["mlp"])
    if device <= 0:
        return None
    return 100.0 * bound * rec["ranged_items"] / device
