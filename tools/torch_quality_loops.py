#!/usr/bin/env python
"""The binary end-to-end quality loops of ``docs/PARITY.md`` ("End-to-end
quality loops") through the port's entry points, on the GPU by default.

    python tools/torch_quality_loops.py --recipe {unet,isensee}
        [--out-dir DIR] [--epochs N] [--device cuda]

- ``unet``: ``configs/fetal_unet.json`` at depth 3 with 16 base filters,
  16 synthetic ellipsoid cases of 64^3, 32^3 patches, 40 epochs, flip /
  permute / contrast augmentation.
- ``isensee``: ``configs/fetal_isensee.json`` (Isensee2017 with the
  reference's defaults: depth 5, 16 base filters, dropout 0.3, three
  segmentation levels), 48 cases of 64^3, whole-volume 64^3 patches, 100
  epochs, the same augmentation.

Everything else is the config file's (batch, lr 5e-4, ``validation_split``
0.8, patch offsets, normalization), with both kernel switches on.
``train.main`` builds the dataset from the cases and trains,
``predict.main`` predicts the validation split (overlap 0 where the patch
is the whole volume, as the model trained; else the config's overlap),
``evaluate.main`` scores the hard Dice. The JAX package ran these recipes
through its CLIs with no committed script; this one makes them
repeatable. Writes ``<out-dir>/summary.json``: the held-out mean and min
hard Dice, the recorded JAX result, the seconds of each entry point and
the kernels' launches. ``--n-cases`` and ``--image-size`` shrink the run
for tests (the patch, the patch offset and the overlap shrink with the
image).
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

IMAGE = 64
# recipe: (config file, overrides, cases, epochs, the JAX record's held-out
# mean and min hard Dice, docs/PARITY.md)
RECIPES = {
    "unet": ("fetal_unet.json", dict(depth=3, n_base_filters=16,
                                     patch_shape=(32, 32, 32)),
             16, 40, (0.9999, 0.9998)),
    "isensee": ("fetal_isensee.json", dict(patch_shape=(64, 64, 64)),
                48, 100, (0.9999, 0.9996)),
}


def make_config(recipe: str, out_dir: str, epochs: int, image: int = IMAGE):
    """The recipe's config, its geometry scaled by ``image`` / 64 (the
    recipe is 64)."""
    from fetal_mri_segmentation_tpu_torch.config import Config

    name, overrides, _, _, _ = RECIPES[recipe]
    cfg = Config.load(str(common.ROOT / "configs" / name))

    def scaled(v):
        return None if v is None else tuple(int(s) * image // IMAGE
                                            for s in v)

    return common.with_kernels(dataclasses.replace(
        cfg, **{**overrides, "patch_shape": scaled(overrides["patch_shape"])},
        n_epochs=epochs, image_shape=(image,) * 3,
        training_patch_start_offset=scaled(cfg.training_patch_start_offset),
        validation_patch_overlap=cfg.validation_patch_overlap * image
        // IMAGE,
        data_file=os.path.join(out_dir, "data"),
        model_file=os.path.join(out_dir, "model.ckpt"),
        training_file=os.path.join(out_dir, "training_ids.pkl"),
        validation_file=os.path.join(out_dir, "validation_ids.pkl"),
        training_log=os.path.join(out_dir, "training.log")))


def main(recipe: str, out_dir: str, epochs=None, device: str = "cuda",
         n_cases=None, image: int = IMAGE) -> dict:
    from fetal_mri_segmentation_tpu_torch.data.synthetic import (
        write_synthetic_dataset)

    _, _, recipe_cases, recipe_epochs, record = RECIPES[recipe]
    epochs = recipe_epochs if epochs is None else epochs
    n_cases = recipe_cases if n_cases is None else n_cases
    os.makedirs(out_dir, exist_ok=True)
    smi = common.card(device)
    print(smi, flush=True)
    cases_dir = os.path.join(out_dir, "cases")
    write_synthetic_dataset(cases_dir, n_cases=n_cases, shape=(image,) * 3)
    cfg = make_config(recipe, out_dir, epochs, image)
    cfg.save(os.path.join(out_dir, "config.json"))
    overlap = (0 if cfg.patch_shape == cfg.image_shape
               else cfg.validation_patch_overlap)
    run = common.run_mains(cfg, cases_dir, out_dir, [1], device=device,
                           overlap=overlap)
    dice = [row["label_1_dice"] for row in run["rows"].values()]
    rows = common.log_rows(cfg.training_log)
    summary = {"recipe": recipe, "mean_dice": float(np.mean(dice)),
               "min_dice": float(np.min(dice)), "n_val_cases": len(dice),
               "epochs": epochs, "epochs_run": len(rows),
               "jax_recorded": {"mean_dice": record[0],
                                "min_dice": record[1]},
               "device": smi,
               "seconds": {k: round(v, 1)
                           for k, v in run["seconds"].items()},
               "launches": run["launches"]}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"{recipe}: held-out mean hard Dice {summary['mean_dice']:.4f} "
          f"(min {summary['min_dice']:.4f}, {len(dice)} cases) after "
          f"{len(rows)} epochs; JAX recorded {record[0]} (min {record[1]})")
    print(common.launch_line(run["launches"]))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recipe", choices=sorted(RECIPES), required=True)
    ap.add_argument("--out-dir", default=None,
                    help="default: torch_quality_<recipe> in the temp dir")
    ap.add_argument("--epochs", type=int, default=None,
                    help="default: the recipe's (unet 40, isensee 100)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-cases", type=int, default=None,
                    help="default: the recipe's (unet 16, isensee 48)")
    ap.add_argument("--image-size", type=int, default=IMAGE,
                    help="cube edge of the cases (the recipes: 64)")
    args = ap.parse_args()
    main(args.recipe, args.out_dir or os.path.join(
        tempfile.gettempdir(), f"torch_quality_{args.recipe}"),
        epochs=args.epochs, device=args.device, n_cases=args.n_cases,
        image=args.image_size)
