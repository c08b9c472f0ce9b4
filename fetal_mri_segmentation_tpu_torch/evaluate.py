"""Per-case hard-Dice reporting: CSV and boxplot (port of the root
``evaluate.py``, which imports the JAX package).

    python -m fetal_mri_segmentation_tpu_torch.evaluate \\
        [--prediction-dir prediction] [--labels 1] [--regions whole:1,2 ...]
        [--surface-metrics] [--output scores.csv]
        [--training-log training.log] [--no-plot]

Globs the per-case directories of a prediction tree (``predict`` without
``--input`` writes one with the truth beside each prediction), loads truth
and prediction NIfTIs and scores the hard Dice per case and label into
``scores.csv``: the root ``evaluate.py``'s columns in its order, under its
index column, written with the ``csv`` module (no pandas). It prints the
mean / std / min / max rows. Device-free: numpy, and scipy for
``--surface-metrics`` (HD95 and ASSD in mm).

Merged-region evaluation scores the UNION of several labels as one binary
mask: ``--regions whole:1,2,4 core:1,4``. Region Dice is robust to the
nested-structure argmax failure, where per-label Dice collapses when argmax
picks the wrong member of a nested pair while their union is still right.

The Dice boxplot and the training curves need matplotlib; where it is
absent the plots are skipped with a note.
"""

from __future__ import annotations

import argparse
import csv
import glob
import math
import os
from typing import Optional

import numpy as np

from fetal_mri_segmentation_tpu_torch.ops.dice import hard_dice
from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti
from fetal_mri_segmentation_tpu_torch.utils.surface_metrics import (
    surface_metric_pair, voxel_spacing_from_affine)


def parse_regions(specs) -> dict:
    """['whole:1,2,4', 'core:1,4'] → {'whole': [1,2,4], 'core': [1,4]}."""
    regions = {}
    for spec in specs or ():
        name, sep, labs = spec.partition(":")
        name = name.strip()
        if not sep or not name or not labs.strip():
            raise SystemExit(
                f"bad --regions spec {spec!r}: expected NAME:LAB[,LAB...] "
                f"e.g. whole:1,2,4")
        try:
            label_list = [int(tok) for tok in labs.split(",") if tok.strip()]
        except ValueError:
            raise SystemExit(f"bad --regions spec {spec!r}: labels must be "
                             f"integers (got {labs!r})")
        if not label_list:
            # 'whole: ,' passes the labs.strip() check above but yields no
            # labels — an all-False mask would score empty-vs-empty Dice 1.0
            raise SystemExit(f"bad --regions spec {spec!r}: no label values "
                             f"(got {labs!r})")
        if name in regions:
            raise SystemExit(f"duplicate region name {name!r} in --regions")
        regions[name] = label_list
    return regions


def _region_mask(volume: np.ndarray, label_list) -> np.ndarray:
    return np.isin(volume, np.asarray(label_list))


def _check_prediction_is_label_map(pred: np.ndarray, case_dir: str):
    """Reject probability maps being scored as hard labels.

    ``predict --prob-map`` writes float probability volumes under the same
    prediction.nii.gz name (reference layout); scoring those with
    ``truth == lab`` silently produces garbage Dice. Detect the two
    prob-map signatures: 4-D multi-channel, or non-integer voxels.
    """
    if pred.ndim == 4 and pred.shape[-1] > 1:
        raise SystemExit(
            f"{case_dir}/prediction.nii.gz is 4-D ({pred.shape}) — this "
            "looks like a probability map (predict --prob-map), not a "
            "label map. Convert it first (the ensemble entry writes label "
            "maps) or re-run predict without --prob-map.")
    if pred.dtype.kind == "f" and not np.array_equal(pred, np.round(pred)):
        raise SystemExit(
            f"{case_dir}/prediction.nii.gz has non-integer voxel values — "
            "this looks like a probability map (predict --prob-map), "
            "not a label map. Convert it first (the ensemble entry writes "
            "label maps) or re-run predict without --prob-map.")


def evaluate_case(case_dir: str, labels, surface_metrics: bool = False,
                  regions: Optional[dict] = None):
    truth_img = load_nifti(os.path.join(case_dir, "truth.nii.gz"))
    truth = truth_img.get_fdata()
    pred = load_nifti(os.path.join(case_dir, "prediction.nii.gz")).get_fdata()
    _check_prediction_is_label_map(pred, case_dir)
    row = {f"label_{lab}_dice": hard_dice(truth == lab, pred == lab)
           for lab in labels}
    regions = regions or {}
    for name, labs in regions.items():
        # merged-region (label-union) hard Dice
        row[f"region_{name}_dice"] = hard_dice(_region_mask(truth, labs),
                                               _region_mask(pred, labs))
    if surface_metrics:
        # boundary-error metrics in mm; see utils/surface_metrics.py for
        # the empty-mask semantics
        spacing = voxel_spacing_from_affine(truth_img.affine)
        for lab in labels:
            hd95, assd_mm = surface_metric_pair(truth == lab, pred == lab,
                                                spacing)
            row[f"label_{lab}_hd95_mm"] = hd95
            row[f"label_{lab}_assd_mm"] = assd_mm
        for name, labs in regions.items():
            hd95, assd_mm = surface_metric_pair(_region_mask(truth, labs),
                                                _region_mask(pred, labs),
                                                spacing)
            row[f"region_{name}_hd95_mm"] = hd95
            row[f"region_{name}_assd_mm"] = assd_mm
    # the reference's hard dice is NaN on empty-vs-empty; here it scores
    # 1.0 and the case is marked instead, so mean and boxplot stay finite
    # without hiding the condition
    row["empty_truth"] = int(all(not np.any(truth == lab) for lab in labels))
    return row


def _cell(value) -> str:
    """One CSV cell as pandas' ``to_csv`` writes it: an integer plain, a
    float by its shortest round-trip repr, NaN empty."""
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    value = float(value)
    return "" if math.isnan(value) else repr(value)


def write_scores(rows: dict, output_csv: str) -> list:
    """``rows`` ({case: {column: value}}) as ``scores.csv``: the case name
    under an empty header as the index column, then the columns in their
    order. Returns the columns."""
    columns = list(next(iter(rows.values())))
    with open(output_csv, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([""] + columns)
        for case, row in rows.items():
            writer.writerow([case] + [_cell(row[c]) for c in columns])
    return columns


def summarize(rows: dict, columns) -> dict:
    """{statistic: {column: value}} for mean, std (sample, as pandas'
    ``describe``), min and max over the cases; NaNs are left out."""
    stats = {name: {} for name in ("mean", "std", "min", "max")}
    for c in columns:
        v = np.asarray([row[c] for row in rows.values()], np.float64)
        v = v[~np.isnan(v)]
        stats["mean"][c] = float(v.mean()) if v.size else float("nan")
        stats["std"][c] = (float(v.std(ddof=1)) if v.size > 1
                           else float("nan"))
        stats["min"][c] = float(v.min()) if v.size else float("nan")
        stats["max"][c] = float(v.max()) if v.size else float("nan")
    return stats


def _read_log(training_log: str) -> dict:
    """The CSV training log as {column: [floats]}."""
    with open(training_log, newline="") as f:
        records = list(csv.DictReader(f))
    return {k: [float(r[k]) if r[k] not in ("", None) else float("nan")
                for r in records] for k in (records[0] if records else {})}


def _plots(rows: dict, columns, output_csv: str,
           training_log: Optional[str]) -> None:
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: skipping the Dice boxplot and "
              "the training curves (scores.csv is complete)")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dice = [c for c in columns if c.endswith("_dice")]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.boxplot([[row[c] for row in rows.values()] for c in dice])
    ax.set_xticklabels(dice)
    ax.set_ylabel("Dice coefficient")
    ax.set_title("Per-case hard Dice")
    fig.tight_layout()
    fig.savefig(os.path.splitext(output_csv)[0] + "_boxplot.png", dpi=120)
    plt.close(fig)

    if training_log and os.path.exists(training_log):
        log = _read_log(training_log)
        fig, ax = plt.subplots(figsize=(6, 4))
        for col in ("loss", "val_loss"):
            if col in log:
                ax.plot(log["epoch"], log[col], label=col)
        ax.set_xlabel("epoch")
        ax.set_ylabel("loss (negative dice)")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.splitext(training_log)[0] + "_curves.png",
                    dpi=120)
        plt.close(fig)


def main(prediction_dir: str, labels, output_csv: str,
         training_log: Optional[str] = None, plot: bool = True,
         surface_metrics: bool = False, regions: Optional[dict] = None):
    """Score every case of ``prediction_dir`` into ``output_csv``; returns
    ``{case: row}``."""
    rows = {}
    no_truth = []
    for case_dir in sorted(glob.glob(os.path.join(prediction_dir, "*"))):
        if not os.path.isdir(case_dir):
            continue
        if not os.path.exists(os.path.join(case_dir, "prediction.nii.gz")):
            continue
        if not os.path.exists(os.path.join(case_dir, "truth.nii.gz")):
            # legitimate for serve output trees (new scans have no ground
            # truth): skip with a note instead of a traceback
            no_truth.append(os.path.basename(case_dir))
            continue
        rows[os.path.basename(case_dir)] = evaluate_case(
            case_dir, labels, surface_metrics=surface_metrics,
            regions=regions)
    if no_truth:
        print(f"skipped {len(no_truth)} case(s) without truth.nii.gz "
              f"(nothing to score against): {', '.join(no_truth[:5])}"
              + (" ..." if len(no_truth) > 5 else ""))

    if not rows:
        raise SystemExit(
            f"no scorable prediction cases under {prediction_dir}"
            + (" — the cases there have predictions but no truth.nii.gz "
               "(serve trees are unscored; predict's validation trees "
               "include the truth)" if no_truth else ""))

    columns = write_scores(rows, output_csv)
    width = max(len(c) for c in columns) + 2
    print(" " * 6 + "".join(c.rjust(width) for c in columns))
    for name, values in summarize(rows, columns).items():
        print(name.ljust(6) + "".join(f"{values[c]:.6f}".rjust(width)
                                      for c in columns))
    print(f"wrote {output_csv} ({len(rows)} cases)")

    if plot:
        _plots(rows, columns, output_csv, training_log)
    return rows


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prediction-dir", default="prediction")
    ap.add_argument("--labels", type=int, nargs="+", default=[1])
    ap.add_argument("--output", default="scores.csv")
    ap.add_argument("--training-log", default="training.log")
    ap.add_argument("--no-plot", action="store_true")
    ap.add_argument("--surface-metrics", action="store_true",
                    help="add HD95 and ASSD columns (mm; boundary error "
                         "the Dice overlap score cannot see)")
    ap.add_argument("--regions", nargs="+", metavar="NAME:LAB[,LAB...]",
                    help="merged-region (label-union) masks to score as one "
                         "binary mask each, e.g. --regions whole:1,2,4 "
                         "core:1,4")
    return ap


if __name__ == "__main__":
    args = _parser().parse_args()
    main(args.prediction_dir, args.labels, args.output,
         training_log=args.training_log, plot=not args.no_plot,
         surface_metrics=args.surface_metrics,
         regions=parse_regions(args.regions))
