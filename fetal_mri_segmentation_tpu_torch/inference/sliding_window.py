"""Whole-volume sliding-window inference (port of
``fetal_mri_segmentation_tpu/inference/sliding_window.py``).

Geometry as in the JAX predictor: the centered corner grid
(``ops/patches.py::compute_patch_indices``), zero padding so every corner
lies inside the padded volume, and the Gaussian weight-sum field, which
depends on the geometry alone and is accumulated once on the host. Per
batch of corners: gather the patches, run the model under
``torch.inference_mode()``, weight by the Gaussian importance map and add
in place into one fp32 accumulator on the device. One division at the end.
(The JAX package's static unroll and tiled segment-sum were workarounds
for XLA's scatter on the TPU; eager in-place adds need neither.)

The model's weights move to the device once, at construction; each volume
is staged to the device in the model's compute dtype (rounded on the host,
so a bf16 model uploads half the bytes).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from fetal_mri_segmentation_tpu.inference.labelmaps import label_map_dtype
from fetal_mri_segmentation_tpu_torch.ops.patches import (
    compute_patch_indices, gaussian_importance_map)
from fetal_mri_segmentation_tpu_torch.utils.device import resolve_device


class SlidingWindowPredictor:
    """Predictor for one volume geometry; reuse it across volumes."""

    def __init__(self, model, config, image_shape: Sequence[int],
                 overlap: int = 16, patch_batch_size: int = 8, device=None):
        self.device = (resolve_device(device) if device is not None
                       else next(model.parameters()).device)
        self.model = model.to(self.device).eval()
        self.config = config
        self.n_labels = config.n_labels
        self.image_shape = tuple(int(s) for s in image_shape)
        self.patch_shape = tuple(int(s) for s in config.patch_shape)
        self.patch_batch_size = int(patch_batch_size)

        corners = compute_patch_indices(self.image_shape, self.patch_shape,
                                        overlap)
        pad_before = np.maximum(-corners.min(axis=0), 0)
        pad_after = np.maximum(
            (corners + self.patch_shape).max(axis=0) - self.image_shape, 0)
        self.pad_before = pad_before
        self.padded_shape = tuple(int(s + b + a) for s, b, a in
                                  zip(self.image_shape, pad_before, pad_after))
        self.corners = [tuple(int(v) for v in c)
                        for c in corners + pad_before[None, :]]

        wmap = gaussian_importance_map(
            self.patch_shape, sigma_scale=config.gaussian_recon_sigma_scale)
        wsum = np.zeros(self.padded_shape, np.float64)
        for c in self.corners:
            wsum[self._window(c)] += wmap
        wsum = np.maximum(wsum, 1e-8).astype(np.float32)
        self.weight_map = torch.from_numpy(wmap)[..., None].to(self.device)
        self.weight_sum = torch.from_numpy(wsum)[..., None].to(self.device)

    def _window(self, corner):
        return tuple(slice(c, c + s) for c, s in zip(corner, self.patch_shape))

    def _stage_volume(self, data_cdhw) -> torch.Tensor:
        """(C, D, H, W) host array -> padded (D', H', W', C) device tensor
        in the model's compute dtype."""
        n_ch = self.config.nb_channels
        if (data_cdhw.ndim != 4 or data_cdhw.shape[0] != n_ch
                or tuple(data_cdhw.shape[-3:]) != self.image_shape):
            raise ValueError(
                f"predictor was built for (C={n_ch}, D, H, W) volumes with "
                f"image_shape={self.image_shape} but got a volume shaped "
                f"{tuple(data_cdhw.shape)} — rebuild the predictor (or "
                "resample the case to the training geometry, as "
                "preprocess_case does)")
        vol = torch.as_tensor(np.asarray(data_cdhw, np.float32))
        vol = vol.to(self.model.dtype).to(self.device)
        total = [p - i for p, i in zip(self.padded_shape, self.image_shape)]
        pad = []
        for axis in (2, 1, 0):  # F.pad lists the last axis first
            before = int(self.pad_before[axis])
            pad += [before, total[axis] - before]
        vol = torch.nn.functional.pad(vol, pad)
        return vol.permute(1, 2, 3, 0).contiguous()

    @torch.inference_mode()
    def predict_probabilities(self, data_cdhw) -> torch.Tensor:
        """(C, D, H, W) -> fp32 probabilities (L, D, H, W) on the device."""
        vol = self._stage_volume(data_cdhw)
        acc = torch.zeros(self.padded_shape + (self.n_labels,),
                          dtype=torch.float32, device=self.device)
        P = self.patch_batch_size
        for start in range(0, len(self.corners), P):
            batch = self.corners[start:start + P]
            patches = torch.stack([vol[self._window(c)] for c in batch])
            preds = self.model(patches).float() * self.weight_map
            for c, pred in zip(batch, preds):
                acc[self._window(c)] += pred
        prob = acc / self.weight_sum
        crop = tuple(slice(int(b), int(b) + s)
                     for b, s in zip(self.pad_before, self.image_shape))
        return prob[crop].permute(3, 0, 1, 2)

    def __call__(self, data_cdhw) -> np.ndarray:
        """(C, D, H, W) -> probabilities (L, D, H, W), float32 on the host."""
        return self.predict_probabilities(data_cdhw).cpu().numpy()

    def predict_labels(self, data_cdhw, threshold: float = 0.5) -> np.ndarray:
        """(C, D, H, W) -> label map (D, H, W), computed on the device.

        Binary: probability > threshold as uint8 0/1. Multi-class: argmax
        over channels mapped through ``config.labels`` (channel i ->
        labels[i]), 0 where no channel clears the threshold — the semantics
        of ``utils/packing.py::device_label_map``."""
        prob = self.predict_probabilities(data_cdhw)
        if self.n_labels == 1:
            return (prob[0] > threshold).to(torch.uint8).cpu().numpy()
        labels = list(self.config.labels or range(1, self.n_labels + 1))
        dtype = label_map_dtype(labels)
        table = torch.tensor(labels, device=prob.device,
                             dtype=torch.uint8 if dtype == np.uint8
                             else torch.int64)
        label_map = table[prob.argmax(dim=0)]
        label_map = torch.where(prob.amax(dim=0) > threshold, label_map,
                                torch.zeros_like(label_map))
        return label_map.cpu().numpy().astype(dtype)
