"""Per-case intensity normalization (numpy).

Copies of ``fetal_mri_segmentation_tpu/data/normalize.py``: the per-case
``normalize_data``, ``window_intensities`` and ``normalize_case``, and the
dataset builder's storage passes ``normalize_data_storage`` (global),
``normalize_data_storage_per_volume`` and
``normalize_data_storage_windowed``, which rewrite a stored (N, C, D, H, W)
array case by case (``data/build.py`` runs them over the memory map). They
are copied, not imported: importing that module runs ``fetal_mri_segmentation_tpu/data/
__init__.py``, which imports h5py. Tests hold each copy equal to its
original.
"""

from __future__ import annotations

import numpy as np


def normalize_data(data: np.ndarray, mean: np.ndarray, std: np.ndarray
                   ) -> np.ndarray:
    """(data - mean) / std with per-channel broadcast over (C, D, H, W)."""
    mean = np.asarray(mean, dtype=np.float32).reshape(-1, 1, 1, 1)
    std = np.asarray(std, dtype=np.float32).reshape(-1, 1, 1, 1)
    std = np.where(std == 0, 1.0, std)
    return (data - mean) / std


def normalize_data_storage(data_storage):
    """Global z-score: average the per-volume moments, apply one (mean, std).

    Returns the per-channel ``(mean, std)`` so the dataset builder can
    persist them (new cases at serving time must be normalized with the
    TRAINING distribution's moments, not their own).
    """
    means, stds = [], []
    n = data_storage.shape[0]
    for i in range(n):
        v = np.asarray(data_storage[i], dtype=np.float32)
        means.append(v.mean(axis=(1, 2, 3)))
        stds.append(v.std(axis=(1, 2, 3)))
    mean = np.mean(means, axis=0)
    std = np.mean(stds, axis=0)
    for i in range(n):
        data_storage[i] = normalize_data(
            np.asarray(data_storage[i], dtype=np.float32), mean, std)
    return mean, std


def normalize_data_storage_per_volume(data_storage) -> None:
    """Per-volume z-score (fetal-fork semantics)."""
    n = data_storage.shape[0]
    for i in range(n):
        v = np.asarray(data_storage[i], dtype=np.float32)
        data_storage[i] = normalize_data(
            v, v.mean(axis=(1, 2, 3)), v.std(axis=(1, 2, 3)))


def window_intensities(data: np.ndarray, lower_percentile: float = 1.0,
                       upper_percentile: float = 99.0) -> np.ndarray:
    """Percentile windowing: clip each channel to its [p_lo, p_hi] range."""
    out = np.empty_like(data, dtype=np.float32)
    for c in range(data.shape[0]):
        lo, hi = np.percentile(data[c], [lower_percentile, upper_percentile])
        out[c] = np.clip(data[c], lo, hi)
    return out


def normalize_case(data: np.ndarray, mode: str,
                   mean=None, std=None,
                   lower_percentile: float = 1.0,
                   upper_percentile: float = 99.0) -> np.ndarray:
    """Normalize one (C, D, H, W) case the way dataset ingest
    (``data/build.py``) normalized the training volumes. ``mode="global"`` needs the training
    dataset's per-channel ``(mean, std)``."""
    data = np.asarray(data, dtype=np.float32)
    if mode is None or mode == "none":
        return data
    if mode == "global":
        if mean is None or std is None:
            raise ValueError(
                "normalize_case(mode='global') needs the training "
                "dataset's (mean, std) — rebuild the HDF5 with this "
                "version (attrs norm_mean/norm_std) or pass them explicitly")
        return normalize_data(data, mean, std)
    if mode == "windowed":
        data = window_intensities(data, lower_percentile, upper_percentile)
    elif mode != "per_volume":
        raise ValueError(f"unknown normalization mode: {mode!r}")
    return normalize_data(data, data.mean(axis=(1, 2, 3)),
                          data.std(axis=(1, 2, 3)))


def normalize_data_storage_windowed(data_storage,
                                    lower_percentile: float = 1.0,
                                    upper_percentile: float = 99.0) -> None:
    """Percentile-window then per-volume z-score ("windowed" mode)."""
    n = data_storage.shape[0]
    for i in range(n):
        v = window_intensities(np.asarray(data_storage[i], dtype=np.float32),
                               lower_percentile, upper_percentile)
        data_storage[i] = normalize_data(
            v, v.mean(axis=(1, 2, 3)), v.std(axis=(1, 2, 3)))
