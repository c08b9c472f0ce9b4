"""Surface-distance metrics for segmentation evaluation (host-side).

A copy of ``fetal_mri_segmentation_tpu/utils/surface_metrics.py`` (importing
it runs that package's ``__init__``, which imports jax); tests hold it equal to its
original. Overlap scores are blind to boundary error: a mask can score
Dice 0.95 while its surface wanders millimetres from the truth. These are
the two standard complements, both in physical units from the NIfTI voxel
spacing:

- **HD95**: the 95th-percentile symmetric Hausdorff distance, the max over
  both directed 95th-percentile surface distances (robust to single
  outlier voxels);
- **ASSD**: the average symmetric surface distance, the mean distance of
  every surface voxel of each mask to the other mask's surface.

Pure numpy/scipy (distance transforms), device-free like ``evaluate``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def voxel_spacing_from_affine(affine: np.ndarray) -> Tuple[float, ...]:
    """Physical voxel size per axis = column norms of the affine's 3x3."""
    a = np.asarray(affine, np.float64)
    return tuple(float(np.linalg.norm(a[:3, i])) for i in range(3))


def _surface(mask: np.ndarray) -> np.ndarray:
    """Boundary voxels: the mask minus its erosion (6-connectivity)."""
    from scipy import ndimage

    structure = ndimage.generate_binary_structure(3, 1)
    return mask & ~ndimage.binary_erosion(mask, structure=structure,
                                          border_value=0)


def surface_distances(truth: np.ndarray, pred: np.ndarray,
                      spacing: Sequence[float] = (1.0, 1.0, 1.0)
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Directed surface-distance samples ``(truth->pred, pred->truth)``
    in the units of ``spacing``. Both masks must be non-empty."""
    from scipy import ndimage

    truth = np.asarray(truth, bool)
    pred = np.asarray(pred, bool)
    t_surf, p_surf = _surface(truth), _surface(pred)
    # distance of every voxel to the nearest surface voxel of the OTHER
    # mask (EDT of the complement of the surface, physical sampling)
    dt_to_p = ndimage.distance_transform_edt(~p_surf, sampling=spacing)
    dt_to_t = ndimage.distance_transform_edt(~t_surf, sampling=spacing)
    return dt_to_p[t_surf], dt_to_t[p_surf]


def surface_metric_pair(truth: np.ndarray, pred: np.ndarray,
                        spacing: Sequence[float] = (1.0, 1.0, 1.0)
                        ) -> Tuple[float, float]:
    """``(hd95, assd)`` from ONE surface-distance evaluation — the two
    distance transforms dominate the cost, so callers scoring both metrics
    (evaluate.py --surface-metrics) should use this instead of calling
    :func:`hausdorff95` and :func:`assd` separately (which would repeat
    the transforms).

    Empty-mask semantics: both empty -> (0.0, 0.0) (nothing to disagree
    on, matching evaluate.py's empty-vs-empty Dice=1.0 + flag convention);
    exactly one empty -> (NaN, NaN) (boundary distance undefined — the
    Dice column already scores the total miss).
    """
    t_any, p_any = bool(np.any(truth)), bool(np.any(pred))
    if not t_any and not p_any:
        return 0.0, 0.0
    if t_any != p_any:
        return float("nan"), float("nan")
    d_tp, d_pt = surface_distances(truth, pred, spacing)
    hd95 = float(max(np.percentile(d_tp, 95), np.percentile(d_pt, 95)))
    a = float((d_tp.sum() + d_pt.sum()) / (d_tp.size + d_pt.size))
    return hd95, a


def hausdorff95(truth: np.ndarray, pred: np.ndarray,
                spacing: Sequence[float] = (1.0, 1.0, 1.0)) -> float:
    """95th-percentile symmetric Hausdorff distance (see
    :func:`surface_metric_pair` for the empty-mask semantics)."""
    return surface_metric_pair(truth, pred, spacing)[0]


def assd(truth: np.ndarray, pred: np.ndarray,
         spacing: Sequence[float] = (1.0, 1.0, 1.0)) -> float:
    """Average symmetric surface distance (see :func:`surface_metric_pair`
    for the empty-mask semantics)."""
    return surface_metric_pair(truth, pred, spacing)[1]
