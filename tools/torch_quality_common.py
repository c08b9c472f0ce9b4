"""What the port's quality loops share (``tools/torch_parity_dice.py``,
``torch_multiclass_quality.py``, ``torch_quality_loops.py``; the
``quality`` phase of ``chip_smoke.py`` runs the parity recipe through the
same functions).

- :func:`with_kernels`: both kernel switches on, so the runs train and
  predict through the Hopper kernels (on a CPU tensor each kernel route
  runs its plain version);
- :func:`zero_launches` / :func:`read_launches`: the kernels' launch
  counts (each wrapper counts its launches in its ``launches`` attribute);
- :func:`card`: the card's name and power limit as ``nvidia-smi`` prints
  them, or "cpu";
- :func:`run_mains`: one experiment through the port's three entry points,
  ``train.main`` -> ``predict.main`` over the validation split ->
  ``evaluate.main``, with the seconds and the launches of each;
- :func:`curve_record`: the best validation loss's epoch and the collapse
  epoch, if any, of a training log (``tools/multiclass_quality_seeds.py``
  reads the JAX package's logs with it too).

Nothing here imports the JAX package, and nothing at import time imports
the port.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _counters():
    from fetal_mri_segmentation_tpu_torch.ops import conv3x3, dec0
    return (conv3x3.conv3x3, conv3x3.conv3x3_flat,
            dec0.up_concat_conv3x3_kernel)


def zero_launches() -> None:
    for fn in _counters():
        fn.launches = 0


def read_launches() -> dict:
    return {fn.__name__: fn.launches for fn in _counters()}


def with_kernels(config):
    """``config`` with both kernel switches on (both default off)."""
    return dataclasses.replace(config, use_pallas_conv=True,
                               use_pallas_dec0=True)


def card(device: str) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if not str(device).startswith("cuda"):
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _sync(device: str) -> None:
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def log_rows(path: str) -> list:
    """The training log's rows (``train_model``'s CSV)."""
    with open(path) as f:
        return list(csv.DictReader(f))


def curve_record(path: str, rise: float = 0.3, hold: int = 25) -> dict:
    """The best validation loss and its epoch, and the collapse epoch: the
    first epoch whose training loss lies more than ``rise`` above the best
    training loss so far and stays there for ``hold`` epochs (None where
    no epoch does)."""
    rows = log_rows(path)
    loss = [float(r["loss"]) for r in rows]
    val = [float(r["val_loss"]) for r in rows]
    best_val = min(range(len(val)), key=val.__getitem__)
    collapse = None
    for e in range(len(loss) - hold + 1):
        floor = min(loss[:e + 1])
        if all(loss[t] - floor > rise for t in range(e, e + hold)):
            collapse = int(rows[e]["epoch"])
            break
    return {"best_val_epoch": int(rows[best_val]["epoch"]),
            "best_val_loss": val[best_val], "collapse_epoch": collapse}


def run_mains(config, cases_dir: str, out_dir: str, labels, *,
              device: str = "cuda", overlap: Optional[int] = None,
              regions: Optional[dict] = None, seed: int = 0,
              verbose: bool = True) -> dict:
    """``train.main`` (builds ``config.data_file`` from ``cases_dir`` unless
    it exists, writes the split, trains, checkpoints), ``predict.main`` of
    the validation split into ``<out_dir>/prediction`` and ``evaluate.main``
    into ``<out_dir>/scores.csv``. Returns the final train state, the
    number of predicted cases, the scores' rows, each stage's seconds and
    the launches of ``train.main`` and of ``predict.main``."""
    from fetal_mri_segmentation_tpu_torch import evaluate, predict, train

    pred_dir = os.path.join(out_dir, "prediction")
    scores_csv = os.path.join(out_dir, "scores.csv")
    seconds, launches = {}, {}
    zero_launches()
    t0 = time.perf_counter()
    state = train.main(config, cases_dir, seed=seed, verbose=verbose,
                       device=device)
    _sync(device)
    seconds["train"] = time.perf_counter() - t0
    launches["train.main"] = read_launches()
    zero_launches()
    t0 = time.perf_counter()
    n = predict.main(config, output_dir=pred_dir, overlap=overlap,
                     device=device, verbose=verbose)
    _sync(device)
    seconds["predict"] = time.perf_counter() - t0
    launches["predict.main"] = read_launches()
    t0 = time.perf_counter()
    rows = evaluate.main(pred_dir, list(labels), scores_csv,
                         training_log=config.training_log, plot=False,
                         regions=regions)
    seconds["evaluate"] = time.perf_counter() - t0
    return {"state": state, "n_predicted": n, "rows": rows,
            "seconds": seconds, "launches": launches,
            "pred_dir": pred_dir, "scores_csv": scores_csv}


def launch_line(launches: dict) -> str:
    """Each kernel's launches per entry point and over the run."""
    total = {}
    for counts in launches.values():
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    return ("kernel launches: " + "; ".join(
        f"{stage} {counts}" for stage, counts in launches.items())
        + f"; over the run {total}")
