"""Ensemble probability maps from several models into one label map (port
of ``tools/ensemble.py``, which imports the JAX package).

Train K models, average their probabilities, threshold or argmax once:

    python -m fetal_mri_segmentation_tpu_torch.predict --config expA.json \\
        --prob-map --output-dir prob_A ...
    python -m fetal_mri_segmentation_tpu_torch.predict --config expB.json \\
        --prob-map --output-dir prob_B ...
    python -m fetal_mri_segmentation_tpu_torch.ensemble prob_A prob_B \\
        --output ensemble [--weights 2 1] [--threshold 0.5] [--labels 1]

Each input directory holds per-case subdirectories with a
``prediction.nii.gz`` PROBABILITY volume (3-D binary, or 4-D with one
channel per label: what ``predict --prob-map`` writes). For every case
present in ALL inputs, the probabilities are (weighted-)averaged and
converted to a label map with ``prediction_to_image``'s semantics (binary
threshold -> labels[0], or argmax -> labels[i]); the averaged probability
can be kept with ``--save-prob``. Cases missing from some inputs are
skipped with a warning (an ensemble over different case sets is almost
always a mistake: ``--strict`` fails instead). Numpy only, device-free.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from fetal_mri_segmentation_tpu_torch.inference.labelmaps import (
    prediction_to_image)
from fetal_mri_segmentation_tpu_torch.utils.nifti import (
    load_nifti, save_nifti)


def _case_dirs(root: str) -> dict:
    """{case_name: prediction.nii.gz path} for one prediction tree."""
    out = {}
    if not os.path.isdir(root):
        raise FileNotFoundError(f"input directory not found: {root}")
    for name in sorted(os.listdir(root)):
        p = os.path.join(root, name, "prediction.nii.gz")
        if os.path.exists(p):
            out[name] = p
        else:
            p = os.path.join(root, name, "prediction.nii")
            if os.path.exists(p):
                out[name] = p
    if not out:
        raise ValueError(
            f"{root}: no <case>/prediction.nii[.gz] found — inputs must be "
            "prediction trees written by predict --prob-map")
    return out


def _load_prob(path: str, assume_prob: bool = False):
    """(channels-first probability array, affine). 3-D volumes get a
    leading singleton channel; 4-D NIfTIs (multi-class, channel-last on
    disk) are moved back to channel-first."""
    img = load_nifti(path)
    arr = img.get_fdata(dtype=np.float32)
    if arr.ndim == 3:
        arr = arr[None]
    elif arr.ndim == 4:
        arr = np.moveaxis(arr, -1, 0)
    else:
        raise ValueError(f"{path}: expected a 3-D or 4-D probability "
                         f"volume, got shape {arr.shape}")
    if arr.min() < -1e-3 or arr.max() > 1 + 1e-3:
        raise ValueError(
            f"{path}: values outside [0, 1] (min {arr.min():.3g}, max "
            f"{arr.max():.3g}) — this looks like a LABEL map; ensemble "
            "inputs must be probability maps (predict --prob-map)")
    if not assume_prob and np.isin(arr, (0.0, 1.0)).all():
        # a binary label map (labels=[1], the default config) also lands
        # in [0,1] — catch it too. A REAL sigmoid/softmax volume from a
        # very confident model can saturate to exact 0/1 everywhere
        # (sigmoid rounds to 1.0 above logit ~17), so this heuristic has
        # a legitimate false positive; --assume-prob bypasses it.
        raise ValueError(
            f"{path}: every voxel is exactly 0 or 1 — this looks like a "
            "hard LABEL map, not probabilities. If it IS a genuine "
            "(saturated) probability map from predict --prob-map, "
            "re-run with --assume-prob; otherwise re-run predict with "
            "--prob-map to get probabilities")
    return arr, np.asarray(img.affine)


def ensemble_case(paths, weights, threshold: float, labels, out_dir: str,
                  save_prob: bool = False,
                  assume_prob: bool = False) -> np.ndarray:
    """Average one case's probability maps -> write label map; returns it."""
    acc, affine0, shape0 = None, None, None
    for path, w in zip(paths, weights):
        prob, affine = _load_prob(path, assume_prob=assume_prob)
        if acc is None:
            acc, affine0, shape0 = w * prob, affine, prob.shape
        else:
            if prob.shape != shape0:
                raise ValueError(
                    f"{path}: shape {prob.shape} != first input's {shape0}")
            if not np.allclose(affine, affine0, atol=1e-4):
                raise ValueError(
                    f"{path}: affine differs from the first input's — the "
                    "predictions are not on the same grid")
            acc += w * prob
    acc /= sum(weights)
    os.makedirs(out_dir, exist_ok=True)
    if save_prob:
        img = prediction_to_image(acc, affine0, label_map=False)
        save_nifti(img, os.path.join(out_dir, "probability.nii.gz"))
    image = prediction_to_image(acc, affine0, label_map=True,
                                threshold=threshold, labels=labels)
    save_nifti(image, os.path.join(out_dir, "prediction.nii.gz"))
    return np.asarray(image.get_fdata())


def main(inputs, output: str, weights=None, threshold: float = 0.5,
         labels=None, save_prob: bool = False, strict: bool = False,
         assume_prob: bool = False) -> int:
    if len(inputs) < 2:
        raise ValueError("need at least two prediction trees to ensemble")
    if weights is None:
        weights = [1.0] * len(inputs)
    if len(weights) != len(inputs):
        raise ValueError(f"{len(weights)} weights for {len(inputs)} inputs")
    if not all(w > 0 for w in weights):
        raise ValueError("weights must be positive")
    trees = [_case_dirs(d) for d in inputs]
    common = set(trees[0])
    for t in trees[1:]:
        common &= set(t)
    skipped = sorted(set().union(*trees) - common)
    if skipped:
        msg = (f"{len(skipped)} case(s) missing from some inputs, "
               f"skipped: {', '.join(skipped[:5])}"
               + ("..." if len(skipped) > 5 else ""))
        if strict:
            raise ValueError(msg + " (--strict)")
        print(f"[ensemble] WARNING: {msg}", file=sys.stderr)
    if not common:
        raise ValueError("no case is present in every input tree")
    if labels is None:
        # reference get_prediction_labels default: channel i -> i+1. Models
        # trained with other label values (e.g. labels=[4]) need --labels
        # or evaluate will score 0 against their truth.
        print("[ensemble] note: --labels not given; writing default label "
              "values 1..L (channel i -> i+1)", file=sys.stderr)
    for name in sorted(common):
        ensemble_case([t[name] for t in trees], weights, threshold, labels,
                      os.path.join(output, name), save_prob=save_prob,
                      assume_prob=assume_prob)
    print(f"[ensemble] {len(common)} case(s) -> {output}/")
    return len(common)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("inputs", nargs="+",
                    help="two or more prediction trees from "
                         "predict --prob-map")
    ap.add_argument("--output", required=True)
    ap.add_argument("--weights", type=float, nargs="+", default=None,
                    help="per-input weights (default: equal)")
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--labels", type=int, nargs="+", default=None,
                    help="label values (binary: written value; multi-class: "
                         "channel i -> labels[i]; default 1..L)")
    ap.add_argument("--save-prob", action="store_true",
                    help="also write the averaged probability.nii.gz")
    ap.add_argument("--strict", action="store_true",
                    help="error (instead of warn+skip) when case sets differ")
    ap.add_argument("--assume-prob", action="store_true",
                    help="trust inputs as probability maps even when every "
                         "voxel is exactly 0/1 (a very confident model's "
                         "sigmoid can saturate; the hard-label heuristic "
                         "cannot tell the difference)")
    return ap


if __name__ == "__main__":
    a = _parser().parse_args()
    main(a.inputs, a.output, weights=a.weights, threshold=a.threshold,
         labels=a.labels, save_prob=a.save_prob, strict=a.strict,
         assume_prob=a.assume_prob)
