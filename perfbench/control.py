"""Readings that set a cell's limits: the program's numbers on many seeds,
the control's (the reference at float8 e4m3 with one scale per tensor, in
the program's place) and, with ``--fault``, the program's with a fault
planted underneath (``program.FAULTS``). Not run by the benchmark's own
runs; run on the chip at the cell's own size:

    python perfbench/control.py --workload unet-window --seconds 2 \\
        --seeds 11 12 13 [--control] [--fault NAME] [--rehearse]

One JSON line per seed and side: ``{"seed", "side", numbers...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import program, run  # noqa: E402


def readings(workload, seed, seconds, control=False, fault=None,
             rehearse=False):
    """{"program": numbers} and, with ``control``, {"control": numbers}."""
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds)]
                     + (["--rehearse"] if rehearse else []))
    planted = program.FAULTS[fault]() if fault else contextlib.nullcontext()
    with planted:
        _, r = run.build(args)
        r.setup()
        r.window(seconds)
        r.release()
        out = {"program": {c["name"]: c["value"] for c in r.check()}}
    if control:
        out["control"] = {c["name"]: c["value"] for c in r.control()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(program.FAULTS))
    ap.add_argument("--rehearse", action="store_true")
    a = ap.parse_args(argv)
    for seed in a.seeds:
        got = readings(a.workload, seed, a.seconds, a.control, a.fault,
                       a.rehearse)
        for side, numbers in got.items():
            if side == "program" and a.fault:
                side = "fault:" + a.fault
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "side": side, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
