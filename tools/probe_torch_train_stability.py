#!/usr/bin/env python
"""Does the port's training collapse? A sweep on one GPU.

    python tools/probe_torch_train_stability.py [--epochs 4] [--seeds 0 1]
        [--lrs 5e-4 2e-4 1e-4] [--config configs/fetal_unet.json]

Soft Dice with a sigmoid has a flat basin at "predict nothing": once the
logits saturate, the gradient vanishes and the run stays at dice ~ 0
(README, "training dice stuck near 0"). This probe trains the config at
full width through ``python -m fetal_mri_segmentation_tpu_torch.train``'s
``main`` on six synthetic ellipsoid cases (``chip_smoke.py::write_cases``),
for every combination of learning rate, resampling augmentation (scale
and rotation on or off, on top of flip / permute / contrast), kernel
switches and seed, and prints each run's (loss, val_loss) per epoch, with
the card's name and power limit. A run whose loss returns to 0 collapsed.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=str(ROOT / "configs"
                                            / "fetal_unet.json"))
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--lrs", type=float, nargs="+",
                    default=[5e-4, 2e-4, 1e-4])
    args = ap.parse_args()

    import torch

    import chip_smoke
    from fetal_mri_segmentation_tpu_torch import train
    from fetal_mri_segmentation_tpu_torch.config import Config

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = True
    base = Config.load(args.config)
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        chip_smoke.write_cases(work / "cases", n=6)
        run = 0
        for lr in args.lrs:
            for resample in (True, False):
                for kernels in (True, False):
                    for seed in args.seeds:
                        d = work / f"run_{run}"
                        d.mkdir()
                        run += 1
                        cfg = dataclasses.replace(
                            base, use_pallas_conv=kernels,
                            use_pallas_dec0=kernels, n_epochs=args.epochs,
                            initial_learning_rate=lr,
                            distort=0.25 if resample else None,
                            rotate=15.0 if resample else None,
                            data_file=str(work / "data"),
                            model_file=str(d / "model.ckpt"),
                            training_file=str(d / "training_ids.pkl"),
                            validation_file=str(d / "validation_ids.pkl"),
                            training_log=str(d / "training.log"))
                        train.main(cfg, str(work / "cases"), seed=seed,
                                   device="cuda", verbose=False)
                        with open(cfg.training_log) as f:
                            rows = list(csv.DictReader(f))
                        print(f"lr {lr:g} scale+rotation "
                              f"{'on' if resample else 'off'} kernels "
                              f"{'on' if kernels else 'off'} seed {seed}: "
                              + " ".join(
                                  f"({float(r['loss']):.4f}, "
                                  f"{float(r['val_loss']):.4f})"
                                  for r in rows), flush=True)


if __name__ == "__main__":
    main()
