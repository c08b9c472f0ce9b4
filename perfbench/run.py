"""Run one cell of the port's benchmark once, from the checkout's root:

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the cell's inputs and weights from ``--seed`` and warms up;
then the cell's traffic drives ``fetal_mri_segmentation_tpu_torch`` for
``--seconds`` (``--trace 0``: the end-to-end metrics) or through two
profiled stretches (``--trace 1``: the per-layer metrics); then the
outputs are held against the plain reference under ``perfbench/reference``.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``checks``: each number compared with its limit); the
last lines of standard error are the same checks.

Exit codes: 0 a result was printed; 2 no card, or fewer than the cell
asks for; 3 a forbidden module was imported (JAX, its libraries or the JAX
package). ``--rehearse`` runs the cell at the sizes its workload file
gives under ``rehearse``, on the CPU, for the tests: it prints no device
metric.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache a run could fill lives at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, os.path.join(ROOT, "build", "perfbench", _sub))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU, for the tests")
    return ap.parse_args(argv)


def build(args):
    """The cell and its traffic's ``Run``, before set-up."""
    import torch

    cell = harness.load_cell(args.workload)
    if args.rehearse:
        cell = harness.rehearsed(cell)
        device = torch.device("cpu")
    else:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            raise SystemExit(2)
        device = torch.device("cuda", 0)
    return cell, harness.traffic(cell["spec"]["kind"]).Run(cell, args.seed,
                                                           device)


def main(argv=None) -> int:
    import torch

    args = parse(argv)
    cell, run = build(args)
    run.setup()
    breakdown = None
    if args.trace:
        record = run.traced()
        metrics = harness.read_per_layer(cell["name"], record)
        breakdown = record.get("breakdown")
    else:
        setup_s = harness.process_age_s()
        e2e = run.window(args.seconds)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in harness.metrics_for("end_to_end", cell["name"])}
    device = {"platform": "gpu", "kind": "", "count": cell["chips"],
              "memory_peak_bytes": 0}
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        device["kind"] = torch.cuda.get_device_name(0)
        device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    bad = harness.forbidden_loaded()
    if bad:
        print(f"forbidden modules imported: {bad}", file=sys.stderr)
        return 3
    if args.trace:
        device["busy_s"] = record["busy_s"]
        device["window_s"] = record["window_s"]
    run.release()
    checks = run.check()
    correct = harness.judge(checks)
    if args.rehearse:
        # no device metric comes from a CPU run
        device = {"platform": "cpu-rehearsal", "count": 0}
        metrics = {}
    line = harness.result_line(correct, run.attempted, run.failed, metrics,
                               device, checks, breakdown)
    print(line, flush=True)
    harness.print_checks(checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
