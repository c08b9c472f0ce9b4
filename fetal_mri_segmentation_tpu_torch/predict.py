"""Predict NIfTI cases with the port, on the GPU by default.

    python -m fetal_mri_segmentation_tpu_torch.predict --config CFG \\
        [--params PARAMS.npz] [--input CASE [CASE ...]]
        [--output-dir prediction]
        [--overlap N] [--patch-batch-size N] [--threshold T]
        [--direct] [--tta] [--tta-mode {permute,flips}]
        [--device-preprocess] [--prob-map]
        [--prob-dtype {float32,float16,uint8,uint16}] [--device cuda]

Each CASE is a directory with ``<modality>.nii[.gz]`` files (and optionally
``truth.nii[.gz]``) or a single NIfTI file for one-modality configs. The
output tree is ``<output-dir>/<case>/prediction.nii.gz`` plus the
preprocessed ``data_<modality>`` and ``truth`` volumes, with the case names
of ``predict.py --input``. The cases run through a two-stage pipeline
(``inference/predict.py::predict_cases_pipelined``). Without ``--input``
every case of the validation split (``config.validation_file``) is
predicted from the dataset at ``config.data_file`` into
``<output-dir>/<subject id>/`` (``run_validation_cases``), as the root
``predict.py`` does. The weights come from the port's own checkpoint at
``config.model_file`` (written by ``python -m
fetal_mri_segmentation_tpu_torch.train``), or with ``--params`` from the
flattened flax params that ``tools/export_params_npz.py`` writes from a
checkpoint of the JAX package. ``normalization="global"`` reads the
training moments from the dataset, once. ``--device cuda`` on a machine
without CUDA raises.

``--direct`` runs one whole-volume forward instead of the patch grid;
``--tta`` averages over the 48 cube symmetries and ``--tta-mode flips``
over the 8 axis flips (``--tta-mode`` implies ``--tta``);
``--device-preprocess`` resamples and normalizes on the device;
``--prob-map`` writes the probability map, moved to the host in
``--prob-dtype`` (uint8 / uint16 stay integer on disk via NIfTI
``scl_slope``). Not ported yet, each refused by name: ``--export``
(``torch.export``), ``--from-keras`` (Keras interop), ``--num-devices``
(DDP) and ``--spatial-devices`` (spatial sharding over more than one
device), all under ROADMAP.md queue 1.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from fetal_mri_segmentation_tpu_torch.config import Config
from fetal_mri_segmentation_tpu_torch.data.build import open_data_file
from fetal_mri_segmentation_tpu_torch.inference.predict import (
    build_serving_predictor, load_global_moments, load_serving_model,
    make_device_preprocessor, predict_cases_pipelined, resolve_tta,
    run_validation_cases)
from fetal_mri_segmentation_tpu_torch.utils.io_utils import (
    case_name_from_path)


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


def check_flags(inputs, *, device_preprocess=False, prob_map=False,
                prob_dtype="float32", export_path=None, from_keras=None,
                num_devices=1, spatial_devices=1) -> None:
    """The root ``predict.py``'s flag validation, before any model is
    built, then the port's refusals of what it does not run yet."""
    multi = ((num_devices or 1) > 1) or ((spatial_devices or 1) > 1)
    if inputs and multi:
        raise ValueError(
            "--input is single-device; --num-devices/--spatial-devices "
            "apply to the validation-set path only")
    if device_preprocess and not inputs:
        raise ValueError("--device-preprocess applies to raw-NIfTI ingest "
                         "(--input); the validation set is already "
                         "preprocessed inside the dataset")
    if prob_map and export_path:
        raise ValueError("--export serializes the LABEL-MAP program; "
                         "probability output (--prob-map) is not exportable")
    if prob_dtype != "float32" and not prob_map:
        raise ValueError("--prob-dtype applies to the probability-map "
                         "transfer only — pass --prob-map (label-map "
                         "output already uses the device-side label map)")
    if from_keras:
        raise NotImplementedError(
            "--from-keras: Keras interop is not ported yet (ROADMAP.md "
            "queue 1, interop)")
    if export_path:
        raise NotImplementedError(
            "--export: the portable program (torch.export) is not ported "
            "yet (ROADMAP.md queue 1, utils/export.py)")
    if multi:
        raise NotImplementedError(
            "--num-devices/--spatial-devices: multi-GPU prediction is not "
            "ported yet (ROADMAP.md queue 1, DDP and spatial sharding over "
            "more than one device)")


def main(config: Config, params: Optional[str] = None,
         inputs: Optional[Sequence[str]] = None, output_dir: str = "prediction", overlap: Optional[int] = None,
         patch_batch_size: int = 8, threshold: float = 0.5,
         device: str = "cuda", verbose: bool = True, *, tta=False,
         direct: bool = False, device_preprocess: bool = False,
         prob_map: bool = False, prob_dtype: str = "float32",
         export_path: Optional[str] = None, from_keras: Optional[str] = None,
         num_devices: int = 1, spatial_devices: int = 1) -> int:
    """Predict ``inputs``, or without them the dataset's validation split,
    into ``output_dir``; returns the number of cases. ``params``: an
    exported ``.npz``, or None for the checkpoint at ``config.model_file``.
    ``tta``: False | True/"permute" | "flips" (``resolve_tta``)."""
    check_flags(inputs, device_preprocess=device_preprocess,
                prob_map=prob_map, prob_dtype=prob_dtype,
                export_path=export_path, from_keras=from_keras,
                num_devices=num_devices, spatial_devices=spatial_devices)
    if overlap is None:
        overlap = config.validation_patch_overlap
    model = load_serving_model(config, params, device)
    if not inputs:
        with open_data_file(config.data_file) as data_file:
            n = run_validation_cases(
                config.validation_file, model, data_file, config,
                output_dir=output_dir, overlap=overlap, permute=tta,
                patch_batch_size=patch_batch_size, direct=direct,
                output_label_map=not prob_map, threshold=threshold,
                prob_dtype=prob_dtype, device=device)
        if verbose:
            print(f"predictions written under {output_dir}/")
        return n
    predictor = build_serving_predictor(
        model, config, direct=direct, tta=tta, overlap=overlap,
        patch_batch_size=patch_batch_size, device=device)
    # the training distribution's moments, loaded once and not per case
    moments = (load_global_moments(config.data_file)
               if config.normalization == "global" else None)
    device_pre = (make_device_preprocessor(model, config, moments=moments)
                  if device_preprocess else None)
    cases = [(path, os.path.join(output_dir, name))
             for path, name in zip(inputs, assign_output_names(inputs))]
    return predict_cases_pipelined(
        cases, predictor, config, threshold=threshold,
        global_moments=moments, device_pre=device_pre, verbose=verbose,
        output_label_map=not prob_map, prob_dtype=prob_dtype)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True, help="experiment JSON")
    ap.add_argument("--params", default=None,
                    help="flattened flax params (.npz); default: the "
                         "port's checkpoint at the config's model_file")
    ap.add_argument("--input", nargs="+", default=None, metavar="CASE",
                    help="ad-hoc NIfTI cases; default: the dataset's "
                         "validation split")
    ap.add_argument("--output-dir", default="prediction")
    ap.add_argument("--overlap", type=int, default=None,
                    help="patch overlap (default: the config's "
                         "validation_patch_overlap)")
    ap.add_argument("--patch-batch-size", type=int, default=8)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--direct", action="store_true",
                    help="one whole-volume forward, no patch grid (dims "
                         "must divide 2^(depth-1))")
    ap.add_argument("--tta", action="store_true",
                    help="test-time augmentation averaging (see --tta-mode)")
    ap.add_argument("--tta-mode", choices=["permute", "flips"], default=None,
                    help="implies --tta. permute = the 48 cube symmetries "
                         "(cubic patches or volume; the default with bare "
                         "--tta); flips = the 8 axis flips (any shape)")
    ap.add_argument("--device-preprocess", action="store_true",
                    help="resample and normalize on the device (the host "
                         "reads and crops only)")
    ap.add_argument("--prob-map", action="store_true",
                    help="write the probability map instead of the label "
                         "map")
    ap.add_argument("--prob-dtype",
                    choices=["float32", "float16", "uint8", "uint16"],
                    default="float32",
                    help="with --prob-map: the device-to-host dtype; "
                         "uint8/uint16 stay integer on disk (NIfTI "
                         "scl_slope)")
    ap.add_argument("--export", metavar="PATH", default=None,
                    help="not ported yet (torch.export)")
    ap.add_argument("--from-keras", metavar="MODEL_H5", default=None,
                    help="not ported yet")
    ap.add_argument("--num-devices", type=int, default=1,
                    help="not ported yet (one device)")
    ap.add_argument("--spatial-devices", type=int, default=1,
                    help="not ported yet (one device)")
    ap.add_argument("--device", default="cuda")
    return ap


if __name__ == "__main__":
    args = _parser().parse_args()
    main(Config.load(args.config), args.params, args.input,
         output_dir=args.output_dir, overlap=args.overlap,
         patch_batch_size=args.patch_batch_size, threshold=args.threshold,
         device=args.device, tta=resolve_tta(args.tta, args.tta_mode),
         direct=args.direct, device_preprocess=args.device_preprocess,
         prob_map=args.prob_map, prob_dtype=args.prob_dtype,
         export_path=args.export, from_keras=args.from_keras,
         num_devices=args.num_devices, spatial_devices=args.spatial_devices)
