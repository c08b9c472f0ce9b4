"""The label map of a probability map, on its device (port of
``fetal_mri_segmentation_tpu/utils/packing.py::device_label_map``).

One implementation shared by the sliding-window and the direct predictor
so the label-map semantics cannot drift between serving modes. The JAX
package bit-packs binary masks for a thin device link; on the card the
uint8 map (2 MiB at 128^3) crosses PCIe in well under a millisecond, so the
port moves it unpacked.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fetal_mri_segmentation_tpu_torch.inference.labelmaps import (
    label_map_dtype)


def device_label_map(prob: torch.Tensor, threshold: float, n_labels: int,
                     labels) -> torch.Tensor:
    """(L, D, H, W) probabilities -> (D, H, W) label map on their device,
    without a synchronization.

    Binary (``n_labels == 1``): ``prob > threshold`` as uint8 0/1.
    Multi-class: argmax over channels mapped through ``labels`` (channel i
    -> labels[i], the reference's prediction_to_image), 0 where no channel
    clears ``threshold``; uint8 where the labels fit, else int32 (torch
    gathers no uint16 on every device), narrowed on the host by
    :func:`host_label_map`."""
    if n_labels == 1:
        return (prob[0] > threshold).to(torch.uint8)
    lab_list = list(labels or range(1, n_labels + 1))
    dtype = (torch.uint8 if label_map_dtype(lab_list) == np.uint8
             else torch.int32)
    table = _label_table(tuple(lab_list), dtype, prob.device)
    label_map = table[prob.argmax(dim=0)]
    return torch.where(prob.amax(dim=0) > threshold, label_map,
                       torch.zeros_like(label_map))


@functools.cache
def _label_table(labels: tuple, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    # one copy per device: a host-to-device copy on every call would wait
    # for the stream to drain. Made outside inference mode, as the symmetry
    # tables are (ops/augment.py).
    with torch.inference_mode(False):
        return torch.tensor(labels, dtype=dtype, device=device)


def host_label_map(out, n_labels: int, labels) -> np.ndarray:
    """A :func:`device_label_map` result on the host, in the smallest
    unsigned dtype that holds every label (``label_map_dtype``)."""
    arr = out.cpu().numpy() if isinstance(out, torch.Tensor) else out
    if n_labels == 1:
        return np.asarray(arr, np.uint8)
    return np.asarray(arr).astype(
        label_map_dtype(labels or range(1, n_labels + 1)))
