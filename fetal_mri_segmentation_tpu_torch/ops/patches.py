"""Patch-grid math for sliding-window inference and patch sampling (numpy).

Copies of ``fetal_mri_segmentation_tpu/ops/patches.py::
compute_patch_indices``, ``get_set_of_patch_indices``,
``gaussian_importance_map``, ``get_random_nd_index`` and
``get_patch_from_3d_data`` (its numpy path; the JAX package's native
memcpy loader is not used here). They are copied, not imported: importing that
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


def get_random_nd_index(index_max: Sequence[int],
                        rng: Optional[np.random.Generator] = None
                        ) -> np.ndarray:
    """Random nd index in [0, index_max] inclusive."""
    rng = rng or np.random.default_rng()
    return np.asarray([rng.integers(0, m, endpoint=True) for m in index_max],
                      dtype=np.int64)


def get_patch_from_3d_data(data: np.ndarray, patch_shape: Sequence[int],
                           patch_index: Sequence[int]) -> np.ndarray:
    """Slice a (possibly out-of-bounds) patch of the last three axes of
    ``data`` (..., D, H, W); out-of-bounds reads are zero. A patch inside
    the volume is a view of ``data``.

    The JAX package's numpy path slices with a negative stop, and returns
    a patch of the wrong shape, when the patch lies wholly outside the
    volume along an axis; its native loader, which it uses where it is
    built, returns zeros, as this copy does."""
    patch_shape = np.asarray(patch_shape, dtype=np.int64)
    patch_index = np.asarray(patch_index, dtype=np.int64)
    image_shape = np.asarray(data.shape[-3:], dtype=np.int64)

    lo = np.clip(patch_index, 0, image_shape)
    hi = np.maximum(np.clip(patch_index + patch_shape, 0, image_shape), lo)
    src = (...,) + tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
    if np.array_equal(hi - lo, patch_shape):
        return data[src]
    patch = np.zeros(data.shape[:-3] + tuple(int(s) for s in patch_shape),
                     data.dtype)
    dst = (...,) + tuple(slice(int(a - i), int(b - i))
                         for a, b, i in zip(lo, hi, patch_index))
    patch[dst] = data[src]
    return patch
