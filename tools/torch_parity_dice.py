#!/usr/bin/env python
"""Dice parity of the port: the root ``parity_dice.py``'s recipe through
the port's entry points, on the GPU by default.

    python tools/torch_parity_dice.py [--out-dir DIR]
        [--epochs 30] [--device cuda] [--keras] [--seed 0]

The recipe of ``parity_dice.py::make_config``: a depth-3 U-Net with 8 base
filters trained on whole 32^3 volumes (12 synthetic ellipsoid cases
written at 36^3, resampled, per-volume normalized, no crop), batch 3, lr
5e-4, 30 epochs, no augmentation, ``validation_split`` 0.75, split seed 0,
predicted with overlap 0. The dataset is the port's own
(``data/build.py``); ``train.main`` -> ``predict.main`` over the
validation split -> ``evaluate.main`` score each held-out case's hard
Dice, with both kernel switches on. Without ``--keras`` (the card's
machine has no Keras) the recorded CPU-Keras and JAX means of the same
recipe (``docs/PARITY.md``, "Dice parity vs CPU-Keras": 0.9556 and 0.9597)
are printed beside the port's; with it, ``baseline_keras.build_keras_unet3d``
trains on the same arrays and split, as ``parity_dice.py`` does.

Writes ``<out-dir>/parity_dice.csv`` (per case: ours, keras, delta) and
``<out-dir>/summary.json`` (``parity_dice.py``'s keys, plus where the
Keras number came from, the recorded JAX mean, the seconds and the
kernels' launches). ``--n-cases`` and ``--image-size`` shrink the run for
tests; ``--seed`` (the recipe: 0) seeds the split, the initial weights and
the batch order, to read the recipe's spread over seeds.
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

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_quality_common as common  # noqa: E402

IMAGE = (32, 32, 32)
CASE_SHAPE = (36, 36, 36)
N_CASES = 12
LR = 5e-4
EPOCHS = 30
# docs/PARITY.md, "Dice parity vs CPU-Keras": the same recipe's held-out
# mean hard Dice, CPU-Keras and the JAX package
KERAS_RECORDED_MEAN = 0.9556
JAX_RECORDED_MEAN = 0.9597


def build_dataset(out_dir: str, n_cases: int = N_CASES, image=IMAGE) -> str:
    """The synthetic cases and the port's dataset built from them, as
    ``parity_dice.py::build_dataset`` builds its HDF5 file."""
    from fetal_mri_segmentation_tpu_torch.data.build import (
        write_data_to_file)
    from fetal_mri_segmentation_tpu_torch.data.synthetic import (
        write_synthetic_dataset)

    files = write_synthetic_dataset(os.path.join(out_dir, "cases"),
                                    n_cases=n_cases, shape=CASE_SHAPE)
    path = os.path.join(out_dir, "data")
    if not os.path.exists(path):
        write_data_to_file(files, path, image_shape=tuple(image),
                           normalize="per_volume", crop=False)
    return path


def make_config(out_dir: str, data_path: str, epochs: int = EPOCHS,
                image=IMAGE):
    """``parity_dice.py::make_config``, with both kernel switches on."""
    from fetal_mri_segmentation_tpu_torch.config import Config

    image = tuple(image)
    return common.with_kernels(Config(
        model_name="unet", depth=3, n_base_filters=8,
        image_shape=image, patch_shape=image,  # whole-volume
        batch_size=3, validation_batch_size=3,
        n_epochs=epochs, early_stop=0, patience=epochs,
        initial_learning_rate=LR, validation_split=0.75,
        augment=False, flip=False, permute=False, contrast=None,
        skip_blank=False, validation_patch_overlap=0,
        training_patch_start_offset=None,
        data_file=data_path,
        model_file=os.path.join(out_dir, "ours.ckpt"),
        training_file=os.path.join(out_dir, "training_ids.pkl"),
        validation_file=os.path.join(out_dir, "validation_ids.pkl"),
        training_log=os.path.join(out_dir, "ours_training.log")))


def train_and_predict_keras(config, out_dir: str, epochs: int) -> str:
    """``parity_dice.py::train_and_predict_keras`` on the port's dataset
    and split: Keras fits the training cases and predicts the validation
    cases into ``<out_dir>/keras_prediction``."""
    from baseline_keras import build_keras_unet3d

    from fetal_mri_segmentation_tpu_torch.data.build import open_data_file
    from fetal_mri_segmentation_tpu_torch.utils.io_utils import pickle_load
    from fetal_mri_segmentation_tpu_torch.utils.nifti import save_nifti

    image = tuple(config.image_shape)
    kmodel = build_keras_unet3d(depth=3, n_base_filters=8, input_shape=image,
                                learning_rate=LR)
    train_ids = pickle_load(config.training_file)
    val_ids = pickle_load(config.validation_file)
    with open_data_file(config.data_file) as f:
        data = np.asarray(f.root.data[:], np.float32)      # (N, 1, *IMAGE)
        truth = (np.asarray(f.root.truth[:]) > 0).astype(np.float32)
        affines = np.asarray(f.root.affine[:])
    x = np.transpose(data, (0, 2, 3, 4, 1))                # NDHWC
    y = np.transpose(truth, (0, 2, 3, 4, 1))
    kmodel.fit(x[train_ids], y[train_ids], batch_size=config.batch_size,
               epochs=epochs, shuffle=True, verbose=0)
    pred_dir = os.path.join(out_dir, "keras_prediction")
    probs = kmodel.predict(x[val_ids], batch_size=config.batch_size,
                           verbose=0)
    for idx, prob in zip(val_ids, probs):
        case_dir = os.path.join(pred_dir, f"validation_case_{idx}")
        os.makedirs(case_dir, exist_ok=True)
        save_nifti(truth[idx, 0].astype(np.uint8),
                   os.path.join(case_dir, "truth.nii.gz"),
                   affine=affines[idx])
        save_nifti((prob[..., 0] > 0.5).astype(np.uint8),
                   os.path.join(case_dir, "prediction.nii.gz"),
                   affine=affines[idx])
    return pred_dir


def main(out_dir: str, epochs: int = EPOCHS, device: str = "cuda",
         keras: bool = False, n_cases: int = N_CASES, image=IMAGE,
         seed: int = 0) -> dict:
    from fetal_mri_segmentation_tpu_torch import evaluate

    os.makedirs(out_dir, exist_ok=True)
    smi = common.card(device)
    print(smi, flush=True)
    t0 = time.perf_counter()
    data_path = build_dataset(out_dir, n_cases, image)
    build_s = time.perf_counter() - t0
    config = make_config(out_dir, data_path, epochs, image)
    config.save(os.path.join(out_dir, "config.json"))
    run = common.run_mains(config, os.path.join(out_dir, "cases"), out_dir,
                           [1], device=device, overlap=0, seed=seed)
    ours = {case: row["label_1_dice"] for case, row in run["rows"].items()}

    keras_source, keras_dice = "recorded", {}
    if keras:
        keras_dir = train_and_predict_keras(config, out_dir, epochs)
        keras_rows = evaluate.main(keras_dir, [1],
                                   os.path.join(out_dir, "keras.csv"),
                                   plot=False)
        keras_dice = {c: r["label_1_dice"] for c, r in keras_rows.items()}
        keras_source = "measured"
    with open(os.path.join(out_dir, "parity_dice.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["case", "ours_dice", "keras_dice", "delta"])
        for case, d in ours.items():
            k = keras_dice.get(case)
            w.writerow([case, d, "" if k is None else k,
                        "" if k is None else d - k])
    ours_mean = float(np.mean(list(ours.values())))
    keras_mean = (float(np.mean([keras_dice[c] for c in ours]))
                  if keras_dice else KERAS_RECORDED_MEAN)
    summary = {"ours_mean_dice": round(ours_mean, 4),
               "keras_mean_dice": round(keras_mean, 4),
               "delta_mean": round(ours_mean - keras_mean, 4),
               "n_val_cases": len(ours),
               "epochs": epochs,
               "seed": seed,
               "keras_source": keras_source,
               "jax_recorded_mean_dice": JAX_RECORDED_MEAN,
               "ours_min_dice": round(float(min(ours.values())), 4),
               "device": smi,
               "seconds": {"dataset": round(build_s, 1),
                           **{k: round(v, 1)
                              for k, v in run["seconds"].items()}},
               "launches": run["launches"]}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for case, d in ours.items():
        k = keras_dice.get(case)
        print(f"{case}: ours {d:.4f}"
              + ("" if k is None else f" keras {k:.4f} delta {d - k:+.4f}"))
    print(f"held-out mean hard Dice: port {ours_mean:.4f} (min "
          f"{min(ours.values()):.4f}, {len(ours)} cases); Keras "
          f"{keras_mean:.4f} ({keras_source}); JAX {JAX_RECORDED_MEAN} "
          f"(recorded)")
    print(common.launch_line(run["launches"]))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=os.path.join(
        tempfile.gettempdir(), "torch_parity_dice"))
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keras", action="store_true",
                    help="train the CPU-Keras twin too (needs keras)")
    ap.add_argument("--n-cases", type=int, default=N_CASES,
                    help="cases to write (the recipe: 12)")
    ap.add_argument("--image-size", type=int, default=IMAGE[0],
                    help="cube edge of the dataset's volumes (the recipe: "
                         "32)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the split, the weights and the batch "
                         "order (the recipe: 0)")
    args = ap.parse_args()
    main(args.out_dir, args.epochs, device=args.device, keras=args.keras,
         n_cases=args.n_cases, image=(args.image_size,) * 3, seed=args.seed)
