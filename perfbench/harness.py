"""What every cell's run shares: finding a cell's files by its name, the
checks on the device and on what the process imported, and the result
line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the
checkout's root. Its files, found by name:

- ``perfbench/workloads/<cell>.json``: the traffic kind, its parameters,
  the limits of the numbers that decide ``correct``, and the sizes of the
  CPU rehearsal;
- ``configs`` entry ``file`` of the cell's configuration: the model
  configuration as it is run;
- ``perfbench/traffic/<kind>.py``: the generator of that kind of traffic;
- ``perfbench/metrics/<metric>.py``: the reader of each per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "fetal_mri_segmentation_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``), or since this
    module was imported where ``/proc`` is missing."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic(kind: str):
    """The module of a kind of traffic, ``traffic/<kind>.py``."""
    return load_module(os.path.join(BENCH_DIR, "traffic", kind + ".py"),
                       "pb_traffic_" + kind)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_cell(name: str) -> dict:
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    spec = load_json(os.path.join(BENCH_DIR, "workloads", name + ".json"))
    return {"name": name, "chips": int(entry["chips"]),
            "config_name": conf["name"],
            "config": load_json(os.path.join(ROOT, conf["file"])),
            "traffic": entry["traffic"], "spec": spec}


def rehearsed(cell: dict) -> dict:
    """The cell at the rehearsal's sizes (``spec["rehearse"]``), with the
    limits it gives for those sizes (bf16 on the CPU at a few channels
    rounds otherwise than the card at the cell's widths)."""
    over = cell["spec"].get("rehearse", {})
    out = dict(cell)
    out["config"] = {**cell["config"], **over.get("config", {})}
    out["spec"] = {**cell["spec"],
                   "params": {**cell["spec"]["params"],
                              **over.get("params", {})},
                   "limits": {**cell["spec"]["limits"],
                              **over.get("limits", {})}}
    return out


def metrics_for(kind: str, cell: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    return [m for m in benchmark()[kind]
            if cell in m.get("workloads", [cell])]


def read_per_layer(cell: str, record: dict) -> Dict[str, dict]:
    out = {}
    for m in metrics_for("per_layer", cell):
        reader = load_module(os.path.join(BENCH_DIR, "metrics",
                                          m["name"] + ".py"),
                             "pb_metric_" + m["name"].replace(".", "_"))
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_loaded() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def judge(checks: List[dict]) -> bool:
    return bool(checks) and all(
        isinstance(c["value"], float) and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks)


def print_checks(checks: List[dict]) -> None:
    for c in checks:
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {c['name']}: {c['value']!r} <= limit {c['limit']!r} "
              f"{verdict}", file=sys.stderr, flush=True)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: List[dict],
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return json.dumps(out)
