#!/usr/bin/env python
"""The multi-class recipe's pass rate over seeds: several
``tools/torch_multiclass_quality.py`` runs at once on one card, one table.

    python tools/torch_multiclass_sweep.py --out-dir DIR [--epochs 500]
        [--parallel 6] [--device cuda] [--runs on:0-11 off:0-5 fp32:0-5]
        [--jax DIR ...]

Each run is ``torch_multiclass_quality.py --epochs E --seed S`` in a
process of its own, its output in ``<out-dir>/<variant>_seed<S>/log.txt``;
``--parallel`` runs share the card at a time (the model is small). The
variants: ``on`` (the recipe: bf16, both kernel switches on), ``off``
(``--kernels-off``) and ``fp32`` (``--compute-dtype float32``, which runs
the stock convolutions: the kernels are bf16 only). The kernels are built
once before the runs start. Writes ``<out-dir>/sweep.json``: each run's summary (the three label means, pass
or fail, the best validation loss's epoch, the collapse epoch, the
kernels' launches), the pass count of each variant, and, given ``--jax``
directories of ``tools/multiclass_quality_seeds.py`` (each
``seed<S>/summary.json`` that exists), the JAX package's pass count and a
one-sided Fisher exact test of the port's ``on`` passes against JAX's
(the probability of as few port passes or fewer, given both counts'
total). ``--n-cases`` and ``--image-size`` shrink the runs for tests.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

TOOL = Path(__file__).resolve().parent / "torch_multiclass_quality.py"
ROOT = TOOL.parents[1]
VARIANTS = {"on": [], "off": ["--kernels-off"],
            "fp32": ["--compute-dtype", "float32"]}


def parse_runs(specs) -> list:
    """``["on:0-11", "off:0-5"]`` -> ``[("on", 0), ..., ("off", 5)]``."""
    runs = []
    for spec in specs:
        variant, seeds = spec.split(":")
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        for part in seeds.split(","):
            lo, _, hi = part.partition("-")
            runs += [(variant, s) for s in range(int(lo), int(hi or lo) + 1)]
    return runs


def fisher_less(a: int, n_a: int, b: int, n_b: int) -> float:
    """One-sided Fisher exact test: the probability, with the margins
    fixed, of ``a`` or fewer passes among ``n_a`` runs when ``a + b`` of
    all ``n_a + n_b`` runs passed."""
    k, n = a + b, n_a + n_b
    total = math.comb(n, k)
    return sum(math.comb(n_a, i) * math.comb(n_b, k - i)
               for i in range(max(0, k - n_b), a + 1)) / total


def jax_records(dirs) -> list:
    out = []
    for d in dirs:
        for path in sorted(Path(d).glob("seed*/summary.json")):
            with open(path) as f:
                out.append(json.load(f))
    return out


def main(out_dir: str, runs, epochs: int = 500, parallel: int = 6,
         device: str = "cuda", jax_dirs=(), extra=()) -> dict:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if str(device).startswith("cuda"):
        sys.path.insert(0, str(ROOT))
        from fetal_mri_segmentation_tpu_torch.ops import cuda_lib
        cuda_lib.build()
    pending, active, failed = list(runs), [], []
    t0 = time.perf_counter()
    while pending or active:
        while pending and len(active) < parallel:
            variant, seed = pending.pop(0)
            run_dir = out / f"{variant}_seed{seed}"
            run_dir.mkdir(exist_ok=True)
            log = open(run_dir / "log.txt", "w")
            cmd = [sys.executable, str(TOOL), "--out-dir", str(run_dir),
                   "--epochs", str(epochs), "--seed", str(seed),
                   "--device", device, *VARIANTS[variant], *extra]
            active.append((variant, seed, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)))
        time.sleep(1)
        for item in list(active):
            variant, seed, log, proc = item
            if proc.poll() is not None:
                log.close()
                active.remove(item)
                if proc.returncode:
                    failed.append((variant, seed, proc.returncode))
    records = []
    for variant, seed in runs:
        path = out / f"{variant}_seed{seed}" / "summary.json"
        if path.exists():
            with open(path) as f:
                records.append({"variant": variant, **json.load(f)})
    passes = {v: [r["seed"] for r in records if r["variant"] == v
                  and r["passed"]] for v in VARIANTS}
    counts = {v: sum(r["variant"] == v for r in records) for v in VARIANTS}
    result = {"epochs": epochs, "seconds": round(
        time.perf_counter() - t0, 1), "failed": failed, "runs": records,
              "passes": passes, "counts": counts}
    jax = jax_records(jax_dirs)
    if jax:
        jax_pass = sum(r["passed"] for r in jax)
        result["jax"] = {"seeds": [r["seed"] for r in jax],
                         "passes": [r["seed"] for r in jax if r["passed"]]}
        result["fisher_on_vs_jax"] = fisher_less(
            len(passes["on"]), counts["on"], jax_pass, len(jax))
    for r in records:
        print(f"{r['variant']} seed {r['seed']}: "
              + " / ".join(f"{r[k][0]:.4f}" for k in ("1", "2", "4"))
              + f" {'pass' if r['passed'] else 'FAIL'}, best val epoch "
              f"{r['best_val_epoch']}, collapse {r['collapse_epoch']}",
              flush=True)
    with open(out / "sweep.json", "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "runs"}))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--parallel", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", nargs="+", default=["on:0-11", "off:0-5",
                                                  "fp32:0-5"])
    ap.add_argument("--jax", nargs="*", default=[],
                    help="out-dirs of tools/multiclass_quality_seeds.py")
    ap.add_argument("--n-cases", type=int, default=None)
    ap.add_argument("--image-size", type=int, default=None)
    args = ap.parse_args()
    extra = []
    if args.n_cases:
        extra += ["--n-cases", str(args.n_cases)]
    if args.image_size:
        extra += ["--image-size", str(args.image_size)]
    result = main(args.out_dir, parse_runs(args.runs), args.epochs,
                  args.parallel, args.device, args.jax, extra)
    sys.exit(1 if result["failed"] else 0)
