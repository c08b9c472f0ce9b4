#!/usr/bin/env python
"""Multi-class end-to-end quality loop of the port: the root
``tools/multiclass_quality.py``'s recipe through the port's entry points,
on the GPU by default.

    python tools/torch_multiclass_quality.py [--out-dir DIR] [--epochs 500]
        [--softmax] [--distort F] [--device cuda] [--seed 0] [--kernels-off]
        [--compute-dtype {bfloat16,float32}]

Synthetic 3-structure volumes (``data/synthetic.py::
write_multiclass_dataset``: disjoint ellipsoids labelled 1, 2 and 4), 24
cases of 40^3, one sigmoid channel per label with the weighted dice
(``--softmax``: softmax over labels (0, 1, 2, 4), the variant that kills
the smallest structure's channel), depth 3, 8 base filters, whole-volume
patches, batch 3, lr 5e-4, ``validation_split`` 0.75, overlap 0, both
kernel switches on. ``train.main`` builds the dataset and trains,
``predict.main`` predicts the validation split as argmax label maps,
``evaluate.main`` scores each label and the merged ``whole`` region
(labels 1, 2, 4). The recipe runs 500 epochs (``docs/PARITY.md``,
"Multi-class end-to-end quality loop"); ``--epochs`` defaults to the JAX
tool's 40.

Writes ``<out-dir>/summary.json`` with the JAX tool's keys (each label's
and the region's (mean, min) held-out hard Dice, ``train_wall_s``,
``distort``) plus pass or fail, the compute dtype, the best validation
loss's epoch and the collapse epoch (``torch_quality_common.py::
curve_record``), the seconds of each entry point and the kernels'
launches, and prints the JAX tool's PASS line when every mean is at least
0.95. ``--n-cases`` and ``--image-size`` shrink the run for tests.
``--seed`` (the recipe: 0) seeds the split, the initial weights, the batch
order and the augmentation, ``--kernels-off`` runs the same recipe on the
stock convolutions and ``--compute-dtype float32`` in fp32 on the stock
convolutions (the recipe: bf16, the Config default; the kernels run in
bf16 only): they read how far a result is the recipe's spread, how far
the kernels' and how far bf16's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_quality_common as common  # noqa: E402

IMAGE = (40, 40, 40)
N_CASES = 24
LABELS = (1, 2, 4)
FOREGROUND = (1, 2, 4)
PASS_MEAN = 0.95


def make_config(out_dir: str, epochs: int, softmax: bool = False,
                distort: float = None, image=IMAGE):
    """``tools/multiclass_quality.py::make_config``, with both kernel
    switches on and the port's dataset directory at ``<out_dir>/data``."""
    from fetal_mri_segmentation_tpu_torch.config import Config

    image = tuple(image)
    labels = (0,) + LABELS if softmax else LABELS
    return common.with_kernels(Config(
        model_name="unet", depth=3, n_base_filters=8,
        distort=distort,
        image_shape=image, patch_shape=image,  # whole-volume
        n_labels=len(labels), labels=labels,
        activation_name="softmax" if softmax else "sigmoid",
        include_label_wise_dice_coefficients=True,
        batch_size=3, validation_batch_size=3,
        n_epochs=epochs, early_stop=0, patience=epochs,
        initial_learning_rate=5e-4, validation_split=0.75,
        skip_blank=False, validation_patch_overlap=0,
        data_file=os.path.join(out_dir, "data"),
        model_file=os.path.join(out_dir, "model.ckpt"),
        training_file=os.path.join(out_dir, "training_ids.pkl"),
        validation_file=os.path.join(out_dir, "validation_ids.pkl"),
        training_log=os.path.join(out_dir, "training.log")))


def summarize(rows: dict, regions: dict) -> dict:
    """Each label's and region's (mean, min) held-out hard Dice, keyed as
    the JAX tool keys them."""
    summary = {}
    for lab in FOREGROUND:
        vals = [row[f"label_{lab}_dice"] for row in rows.values()]
        summary[str(lab)] = (float(np.mean(vals)), float(np.min(vals)))
    for name in regions:
        vals = [row[f"region_{name}_dice"] for row in rows.values()]
        summary[f"region_{name}"] = (float(np.mean(vals)),
                                     float(np.min(vals)))
    return summary


def main(out_dir: str, epochs: int, softmax: bool = False,
         distort: float = None, device: str = "cuda",
         n_cases: int = N_CASES, image=IMAGE, seed: int = 0,
         kernels_off: bool = False,
         compute_dtype: str = "bfloat16") -> dict:
    from fetal_mri_segmentation_tpu_torch.data.synthetic import (
        write_multiclass_dataset)

    os.makedirs(out_dir, exist_ok=True)
    # the Hopper kernels run in bf16 only (models.build_model refuses them
    # on the card in fp32)
    kernels_off = kernels_off or compute_dtype != "bfloat16"
    smi = common.card(device)
    print(smi, flush=True)
    cases_dir = os.path.join(out_dir, "cases")
    write_multiclass_dataset(cases_dir, n_cases=n_cases, shape=tuple(image))
    cfg = make_config(out_dir, epochs, softmax=softmax, distort=distort,
                      image=image)
    if kernels_off:
        cfg = dataclasses.replace(cfg, use_pallas_conv=False,
                                  use_pallas_dec0=False)
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    cfg.save(os.path.join(out_dir, "config.json"))
    # merged-region row beside the per-label Dice: the union mask scores
    # nested structures robustly to the argmax failure (docs/PARITY.md,
    # multi-class failure mode 3)
    regions = {"whole": list(FOREGROUND)}
    # patch_shape == image_shape: overlap 0 predicts one centered
    # whole-volume patch, as the model trained
    run = common.run_mains(cfg, cases_dir, out_dir, FOREGROUND,
                           device=device, overlap=0, regions=regions,
                           seed=seed)
    train_wall = run["seconds"]["train"]
    print(f"train wall: {train_wall:.1f} s (distort={distort})")

    summary = summarize(run["rows"], regions)
    ok = all(m >= PASS_MEAN for m, _ in summary.values())
    print(f"\nheld-out cases: {len(run['rows'])}")
    for key, (mean, low) in summary.items():
        what = f"label {key}" if key.isdigit() else key.replace("_", " ", 1)
        print(f"{what}: mean dice {mean:.4f} min {low:.4f}")
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({**summary, "train_wall_s": round(train_wall, 1),
                   "distort": distort, "epochs": epochs, "seed": seed,
                   "kernels": not kernels_off,
                   "compute_dtype": compute_dtype, "passed": ok,
                   **common.curve_record(cfg.training_log), "device": smi,
                   "seconds": {k: round(v, 1)
                               for k, v in run["seconds"].items()},
                   "launches": run["launches"]}, f, indent=1)
    print(common.launch_line(run["launches"]))
    print("PASS: all labels >= 0.95 mean held-out dice" if ok
          else "BELOW TARGET")
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=os.path.join(
        tempfile.gettempdir(), "torch_mc_quality"))
    ap.add_argument("--epochs", type=int, default=40,
                    help="epochs (the recorded recipe: 500)")
    ap.add_argument("--softmax", action="store_true",
                    help="softmax + explicit background channel variant "
                         "(demonstrates the dead-channel failure mode)")
    ap.add_argument("--distort", type=float, default=None,
                    help="scale-distortion augmentation factor (off by "
                         "default, as in the JAX tool)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-cases", type=int, default=N_CASES,
                    help="cases to write (the recipe: 24)")
    ap.add_argument("--image-size", type=int, default=IMAGE[0],
                    help="cube edge of the cases (the recipe: 40)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the split, the weights, the batch order "
                         "and the augmentation (the recipe: 0)")
    ap.add_argument("--kernels-off", action="store_true",
                    help="both kernel switches off (stock convolutions)")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="compute dtype (the recipe: bfloat16; float32 "
                         "turns the kernel switches off)")
    args = ap.parse_args()
    main(args.out_dir, args.epochs, softmax=args.softmax,
         distort=args.distort, device=args.device, n_cases=args.n_cases,
         image=(args.image_size,) * 3, seed=args.seed,
         kernels_off=args.kernels_off, compute_dtype=args.compute_dtype)
