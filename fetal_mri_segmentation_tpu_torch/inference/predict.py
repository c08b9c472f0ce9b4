"""Per-case serving from NIfTI files (port of the ``--input`` path of
``fetal_mri_segmentation_tpu/inference/predict.py``).

``preprocess_case`` runs dataset ingest's host preprocessing (shared
background crop, resample to ``config.image_shape``, the configured
normalization); ``predict_case`` predicts with a ``SlidingWindowPredictor``
and writes the JAX package's per-case tree: ``data_<modality>.nii.gz``,
``truth.nii.gz`` when the case has one, and ``prediction.nii.gz``.
Cases run one after another.
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

import numpy as np

from fetal_mri_segmentation_tpu.inference.labelmaps import label_map_dtype
from fetal_mri_segmentation_tpu.utils.geometry import process_case_images
from fetal_mri_segmentation_tpu_torch.data.normalize import normalize_case
from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (
    SlidingWindowPredictor)
from fetal_mri_segmentation_tpu_torch.models import build_model
from fetal_mri_segmentation_tpu_torch.utils.device import resolve_device
from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti, save_nifti
from fetal_mri_segmentation_tpu_torch.utils.params import from_flax


def resolve_case_files(path: str, config) -> tuple:
    """``(modality_files, truth_file_or_None)`` for a case directory
    (``<dir>/<modality>.nii[.gz]`` per training modality, plus
    ``truth.nii[.gz]`` when present) or a single one-modality NIfTI file.
    The JAX package's rule, copied: its module imports jax."""
    if os.path.isdir(path):
        files = []
        for m in config.training_modalities:
            for ext in (".nii.gz", ".nii"):
                p = os.path.join(path, m + ext)
                if os.path.exists(p):
                    files.append(p)
                    break
            else:
                raise FileNotFoundError(
                    f"{path}: missing modality file {m}.nii[.gz] "
                    f"(training_modalities={config.training_modalities})")
        truth = None
        for ext in (".nii.gz", ".nii"):
            p = os.path.join(path, "truth" + ext)
            if os.path.exists(p):
                truth = p
                break
        return files, truth
    if len(config.training_modalities) != 1:
        raise ValueError(
            f"{path}: a bare NIfTI file only works for single-modality "
            f"configs; this config trains on "
            f"{config.training_modalities} — pass the case DIRECTORY")
    return [path], None


def preprocess_case(input_path: str, config):
    """Host preprocessing of one NIfTI case, identical to dataset ingest.

    Returns ``(data, affine, truth_image)``: the normalized (C, D, H, W)
    float32 stack, the build-adjusted affine and the resampled truth
    NiftiImage or None."""
    if config.normalization == "global":
        raise NotImplementedError(
            "normalization='global' needs the training moments stored in "
            "the HDF5 dataset, which the port does not read yet "
            "(ROADMAP.md queue 1, item 9)")
    files, truth_file = resolve_case_files(input_path, config)
    all_files = files + ([truth_file] if truth_file else [])
    label_indices = [len(all_files) - 1] if truth_file else []
    images = process_case_images(
        [load_nifti(f) for f in all_files], image_shape=config.image_shape,
        label_indices=label_indices)
    data = np.stack([img.get_fdata(dtype=np.float32)
                     for img in images[:len(files)]], axis=0)
    data = normalize_case(data, config.normalization)
    return data, images[0].affine, (images[-1] if truth_file else None)


def _scale_binary_label(label_map, config):
    """Binary maps carry the configured label value (reference:
    prediction_to_image — data > threshold -> labels[0])."""
    if config.n_labels == 1 and config.labels:
        dt = label_map_dtype([config.labels[0]])
        return label_map.astype(dt) * dt.type(config.labels[0])
    return label_map


def _write_prediction(label_map, config, case_dir: str, affine):
    label_map = _scale_binary_label(label_map, config).astype(
        label_map_dtype(config.labels or range(1, config.n_labels + 1)))
    save_nifti(label_map, os.path.join(case_dir, "prediction.nii.gz"),
               affine=affine)
    return label_map


def write_inputs(data, truth_image, config, out_dir: str, affine) -> None:
    """The per-case ``data_<modality>`` and ``truth`` NIfTIs."""
    for i, modality in enumerate(config.training_modalities):
        save_nifti(np.asarray(data[i], np.float32),
                   os.path.join(out_dir, f"data_{modality}.nii.gz"),
                   affine=affine)
    if truth_image is not None:
        save_nifti(truth_image.get_fdata(dtype=np.float32).astype(np.uint8),
                   os.path.join(out_dir, "truth.nii.gz"), affine=affine)


def predict_case(input_path: str, out_dir: str,
                 predictor: SlidingWindowPredictor, config, *,
                 threshold: float = 0.5) -> np.ndarray:
    """Predict one NIfTI case and write its output tree; returns the
    written label map."""
    data, affine, truth_image = preprocess_case(input_path, config)
    os.makedirs(out_dir, exist_ok=True)
    write_inputs(data, truth_image, config, out_dir, affine)
    label_map = predictor.predict_labels(data, threshold=threshold)
    return _write_prediction(label_map, config, out_dir, affine)


def predict_cases(cases: Iterable[Tuple[str, str]], predictor, config, *,
                  threshold: float = 0.5, verbose: bool = True) -> int:
    """``predict_case`` over ``(input_path, out_dir)`` pairs, in order;
    returns the number of cases predicted."""
    n = 0
    for path, out_dir in cases:
        predict_case(path, out_dir, predictor, config, threshold=threshold)
        if verbose:
            print(f"{path} -> {out_dir}/prediction.nii.gz", flush=True)
        n += 1
    return n


def load_serving_model(config, params_npz: str, device):
    """Build the configured model on ``device`` and load the flattened flax
    params that ``tools/export_params_npz.py`` wrote."""
    model = build_model(config, device)
    with np.load(params_npz) as flat:
        state = from_flax({k: flat[k] for k in flat.files})
    model.load_state_dict(state)
    return model


def build_serving_predictor(model, config, *, direct: bool = False,
                            tta=False, overlap: int = 16,
                            patch_batch_size: int = 8, device=None):
    """The serving predictor: sliding window only for now."""
    if direct:
        raise NotImplementedError(
            "direct whole-volume prediction is not ported yet "
            "(ROADMAP.md queue 1, item 11)")
    if tta:
        raise NotImplementedError(
            "test-time augmentation is not ported yet "
            "(ROADMAP.md queue 1, item 12)")
    return SlidingWindowPredictor(
        model, config, image_shape=config.image_shape, overlap=overlap,
        patch_batch_size=patch_batch_size,
        device=None if device is None else resolve_device(device))
