"""Share of the profiled stretch in which no device operation ran, in
%: 100 * (1 - busy_s / window_s), busy_s the union of the operations'
intervals, so overlapping operations count once."""


def read(rec):
    if rec.get("kind") != "train" or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])

