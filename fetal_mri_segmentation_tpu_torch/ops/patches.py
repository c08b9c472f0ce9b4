"""Patch-grid math for sliding-window inference (numpy).

Copies of ``fetal_mri_segmentation_tpu/ops/patches.py::
compute_patch_indices``, ``get_set_of_patch_indices`` and
``gaussian_importance_map``. They are copied, not imported: importing that
module runs ``fetal_mri_segmentation_tpu/ops/__init__.py``, which imports
jax. Tests hold each copy equal to its original.

Reference semantics (unet3d/utils/patches.py): corners form a grid with step
``patch_size - overlap``; without ``start`` the grid is centered and corners
may be negative, with reads beyond the volume zero-padded.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np


def compute_patch_indices(image_shape: Sequence[int],
                          patch_size: Sequence[int],
                          overlap: Union[int, Sequence[int]],
                          start: Optional[Union[int, Sequence[int]]] = None
                          ) -> np.ndarray:
    """Grid of patch corner indices, centered with negative-start overflow."""
    image_shape = np.asarray(image_shape, dtype=np.int64)
    patch_size = np.asarray(patch_size, dtype=np.int64)
    if isinstance(overlap, (int, np.integer)):
        overlap = np.full(len(image_shape), overlap, dtype=np.int64)
    else:
        overlap = np.asarray(overlap, dtype=np.int64)
    if np.any(overlap >= patch_size):
        raise ValueError(
            f"patch overlap {tuple(overlap)} must be smaller than the patch "
            f"size {tuple(patch_size)} (grid step = patch_size - overlap)")
    if start is None:
        step = patch_size - overlap
        n_patches = np.ceil(image_shape / step.astype(np.float64))
        overflow = step * n_patches - image_shape + overlap
        start = -np.ceil(overflow / 2.0).astype(np.int64)
    elif isinstance(start, (int, np.integer)):
        start = np.full(len(image_shape), start, dtype=np.int64)
    else:
        start = np.asarray(start, dtype=np.int64)
    stop = image_shape + start
    step = patch_size - overlap
    return get_set_of_patch_indices(start, stop, step)


def get_set_of_patch_indices(start: np.ndarray, stop: np.ndarray,
                             step: np.ndarray) -> np.ndarray:
    """Cartesian grid of corners via mgrid."""
    return np.asarray(
        np.mgrid[start[0]:stop[0]:step[0],
                 start[1]:stop[1]:step[1],
                 start[2]:stop[2]:step[2]].reshape(3, -1).T,
        dtype=np.int64)


def gaussian_importance_map(patch_shape: Sequence[int],
                            sigma_scale: float = 0.125,
                            dtype=np.float32) -> np.ndarray:
    """Separable Gaussian window over the patch, peak-normalized to 1, with
    a floor of 1e-3 so border voxels covered by one patch stay defined."""
    maps = []
    for size in patch_shape:
        sigma = max(size * sigma_scale, 1e-8)
        x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
        maps.append(np.exp(-0.5 * (x / sigma) ** 2))
    w = maps[0][:, None, None] * maps[1][None, :, None] * maps[2][None, None, :]
    w = w / w.max()
    w = np.maximum(w, 1e-3 * w.max())
    return w.astype(dtype)
