"""Predict NIfTI cases with the port, on the GPU by default.

    python -m fetal_mri_segmentation_tpu_torch.predict --config CFG \\
        --params PARAMS.npz --input CASE [CASE ...] [--output-dir prediction]
        [--overlap N] [--patch-batch-size N] [--threshold T] [--device cuda]

Each CASE is a directory with ``<modality>.nii[.gz]`` files (and optionally
``truth.nii[.gz]``) or a single NIfTI file for one-modality configs. The
output tree is ``<output-dir>/<case>/prediction.nii.gz`` plus the
preprocessed ``data_<modality>`` and ``truth`` volumes, with the case names
of ``predict.py --input``. ``PARAMS.npz`` holds the flattened flax params
(``tools/export_params_npz.py`` writes it from a trained checkpoint).
``--device cuda`` on a machine without CUDA raises.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from fetal_mri_segmentation_tpu.utils.io_utils import case_name_from_path
from fetal_mri_segmentation_tpu_torch.config import Config
from fetal_mri_segmentation_tpu_torch.inference.predict import (
    build_serving_predictor, load_serving_model, predict_cases)


def assign_output_names(paths: Sequence[str]):
    """Unique output-dir name per input path, in order: the basename without
    a trailing .nii[.gz]; duplicates get ``_2``, ``_3``, ... chosen against
    every name already assigned (the rule of ``predict.py``)."""
    assigned, names = set(), []
    for path in paths:
        base = case_name_from_path(path)
        name, n = base, 1
        while name in assigned:
            n += 1
            name = f"{base}_{n}"
        assigned.add(name)
        names.append(name)
    return names


def main(config: Config, params: str, inputs: Sequence[str],
         output_dir: str = "prediction", overlap: Optional[int] = None,
         patch_batch_size: int = 8, threshold: float = 0.5,
         device: str = "cuda", verbose: bool = True) -> int:
    """Predict ``inputs`` into ``output_dir``; returns the number of cases."""
    if overlap is None:
        overlap = config.validation_patch_overlap
    model = load_serving_model(config, params, device)
    predictor = build_serving_predictor(
        model, config, overlap=overlap, patch_batch_size=patch_batch_size,
        device=device)
    cases = [(path, os.path.join(output_dir, name))
             for path, name in zip(inputs, assign_output_names(inputs))]
    return predict_cases(cases, predictor, config, threshold=threshold,
                         verbose=verbose)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True, help="experiment JSON")
    ap.add_argument("--params", required=True,
                    help="flattened flax params (.npz)")
    ap.add_argument("--input", nargs="+", required=True, metavar="CASE")
    ap.add_argument("--output-dir", default="prediction")
    ap.add_argument("--overlap", type=int, default=None,
                    help="patch overlap (default: the config's "
                         "validation_patch_overlap)")
    ap.add_argument("--patch-batch-size", type=int, default=8)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(Config.load(args.config), args.params, args.input,
         output_dir=args.output_dir, overlap=args.overlap,
         patch_batch_size=args.patch_batch_size, threshold=args.threshold,
         device=args.device)
