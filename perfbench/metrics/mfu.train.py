"""Share of the bf16 peak (989e12 FLOP/s) the profiled stretch reached, in
%: the least FLOPs of its train steps (perfbench/flops.py) over its wall
time."""

from perfbench.peaks import PEAK_BF16_FLOPS


def read(rec):
    if rec.get("kind") != "train" or "flops_per_item" not in rec:
        return None
    return (100.0 * rec["flops_per_item"] * rec["items"] / rec["window_s"]
            / PEAK_BF16_FLOPS)

