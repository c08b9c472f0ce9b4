#!/usr/bin/env python
"""The JAX package's multi-class quality loop over seeds: the pass rate of
``tools/multiclass_quality.py``'s recipe beside the port's
(``tools/torch_multiclass_quality.py --seed``).

    python tools/multiclass_quality_seeds.py --seeds 1 2 3
        [--out-dir DIR] [--epochs 500]

The root tool trains with ``train.main``'s default seed (0) and has no seed
option. This one runs the same recipe (its ``make_config``, 24 synthetic
cases of 40^3 from ``tests/synthetic.py::write_multiclass_dataset``) once
for each seed, with ``train.main(..., seed=s)`` seeding the initial
weights, the split, the batch order and the augmentation, then predicts
and evaluates as the root tool does. Each seed writes
``<out-dir>/seed<s>/summary.json``: each label's and the ``whole``
region's (mean, min) held-out hard Dice, pass or fail against the root
tool's 0.95 line, the best validation loss's epoch and the collapse epoch
(``tools/torch_quality_common.py::curve_record``). The compute dtype is
the recipe's (bf16, the Config default). Runs on whatever platform JAX
picks (``JAX_PLATFORMS=cpu`` for a CPU).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

_TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(_TOOLS))

import multiclass_quality as recipe  # noqa: E402  (sets the root on the path)
import torch_quality_common as common  # noqa: E402

PASS_MEAN = 0.95


def run_seed(out_dir: str, epochs: int, seed: int) -> dict:
    from synthetic import write_multiclass_dataset

    import evaluate as evaluate_cli
    import predict as predict_cli
    import train as train_cli

    os.makedirs(out_dir, exist_ok=True)
    cases_dir = os.path.join(out_dir, "cases")
    write_multiclass_dataset(cases_dir, n_cases=recipe.N_CASES,
                             shape=recipe.IMAGE)
    cfg = recipe.make_config(out_dir, epochs)
    cfg.save(os.path.join(out_dir, "config.json"))

    t0 = time.perf_counter()
    train_cli.main(cfg, cases_dir, overwrite=False, verbose=True, seed=seed)
    train_wall = time.perf_counter() - t0

    pred_dir = os.path.join(out_dir, "prediction")
    predict_cli.main(cfg, output_dir=pred_dir, overlap=0)
    scores_csv = os.path.join(out_dir, "scores.csv")
    regions = {"whole": list(recipe.FOREGROUND)}
    evaluate_cli.main(pred_dir, list(recipe.FOREGROUND), scores_csv,
                      training_log=cfg.training_log, plot=False,
                      regions=regions)

    with open(scores_csv) as f:
        rows = list(csv.DictReader(f))
    summary = {}
    for lab in recipe.FOREGROUND:
        vals = [float(r[f"label_{lab}_dice"]) for r in rows]
        summary[str(lab)] = (float(np.mean(vals)), float(np.min(vals)))
    for name in regions:
        vals = [float(r[f"region_{name}_dice"]) for r in rows]
        summary[f"region_{name}"] = (float(np.mean(vals)),
                                     float(np.min(vals)))
    record = {**summary, "seed": seed, "epochs": epochs,
              "compute_dtype": cfg.compute_dtype,
              "passed": all(m >= PASS_MEAN for m, _ in summary.values()),
              "train_wall_s": round(train_wall, 1),
              **common.curve_record(cfg.training_log)}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    return record


def main(out_dir: str, epochs: int, seeds) -> list:
    return [run_seed(os.path.join(out_dir, f"seed{s}"), epochs, s)
            for s in seeds]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=os.path.join(
        tempfile.gettempdir(), "mc_quality_seeds"))
    ap.add_argument("--epochs", type=int, default=500,
                    help="epochs (the recorded recipe: 500)")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    main(args.out_dir, args.epochs, args.seeds)
