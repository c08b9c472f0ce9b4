"""Probability → label-map conversion (pure numpy): a copy of
``fetal_mri_segmentation_tpu/inference/labelmaps.py``, kept in the port so
that the port imports nothing of the JAX package.

Reference: unet3d/prediction.py::get_prediction_labels,
prediction_to_image.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from fetal_mri_segmentation_tpu_torch.utils.nifti import NiftiImage


def label_map_dtype(labels) -> np.dtype:
    """Smallest unsigned dtype that holds every label value exactly.

    uint8 matches the reference's truth storage (data.py truth_dtype=uint8)
    for ordinary label sets; larger values (e.g. --labels 500 on the
    ensemble CLI) widen instead of silently wrapping modulo 256.
    """
    labels = np.asarray(list(labels))
    if labels.size and labels.min() < 0:
        raise ValueError(f"label values must be non-negative, got "
                         f"{labels.min()}")
    top = int(labels.max()) if labels.size else 1
    for dt in (np.uint8, np.uint16, np.uint32):
        if top <= np.iinfo(dt).max:
            return np.dtype(dt)
    raise ValueError(f"label value {top} too large for uint32 label maps")


def get_prediction_labels(prediction: np.ndarray, threshold: float = 0.5,
                          labels: Optional[Sequence[int]] = None) -> np.ndarray:
    """(L, D, H, W) probabilities → integer label map.

    Reference: prediction.py::get_prediction_labels — argmax over label
    channels, voxels below threshold → 0, channel i → labels[i].
    """
    n_labels = prediction.shape[0]
    label_arr = np.asarray(labels if labels is not None
                           else range(1, n_labels + 1))
    argmax = prediction.argmax(axis=0)
    label_map = label_arr[argmax]
    label_map[prediction.max(axis=0) <= threshold] = 0
    return label_map.astype(label_map_dtype(label_arr))


def prediction_to_image(prediction: np.ndarray, affine: np.ndarray,
                        label_map: bool = False, threshold: float = 0.5,
                        labels: Optional[Sequence[int]] = None) -> NiftiImage:
    """Probability map → NIfTI (binary threshold or multi-class argmax).

    Reference: prediction.py::prediction_to_image.
    """
    if prediction.shape[0] == 1:
        data = prediction[0]
        if label_map:
            lab = labels[0] if labels else 1
            data = np.where(data > threshold, lab,
                            0).astype(label_map_dtype([lab]))
    elif label_map:
        data = get_prediction_labels(prediction, threshold=threshold,
                                     labels=labels)
    else:
        # multi-channel probability image (4D)
        data = np.moveaxis(prediction, 0, -1)
    return NiftiImage(np.asarray(data), np.asarray(affine))
