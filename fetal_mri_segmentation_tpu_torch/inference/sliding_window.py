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

Optional patch-level test-time augmentation averages the model's output
over the 48 cube symmetries (``tta="permute"``, cubic patches only; the
reference's ``predict(permute=True)``) or the 8 axis flips
(``tta="flips"``, any patch shape): one forward of the patch batch per
member, mapped back by the inverse symmetry.

The model's weights move to the device once, at construction. A volume is
staged in the model's compute dtype (``utils/residency.py::
stage_to_device``); a tensor already on the card is used in place. The
``*_async`` calls enqueue the whole volume's work and return device tensors
without a synchronization; ``unpack_*`` copies the result to the host.

Spans (``utils/profiling.py``, recorded while a profiler runs): one
``window.case`` a volume, around ``window.stage`` (upload, pad, NDHWC
copy), per patch batch ``window.gather`` (the stack of its patches),
``window.model`` (the forward and its TTA members) and
``window.overlap_add`` (the weighting and the in-place adds), and
``window.finish`` (the division, the crop and the label map or transfer
cast); ``window.fetch`` around ``unpack_*``, under the case's request.

The patch grid is walked in batches of ``patch_batch_size`` corners, and
:meth:`SlidingWindowPredictor.accumulate` adds any range of those batches
into an accumulator: ``parallel/distributed.py::make_sharded_predictor``
gives each rank of a mesh a contiguous share of them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from fetal_mri_segmentation_tpu_torch.models.layers import set_spatial_group
from fetal_mri_segmentation_tpu_torch.ops.augment import (
    permute_volume, reverse_permute_volume)
from fetal_mri_segmentation_tpu_torch.ops.patches import (
    compute_patch_indices, gaussian_importance_map)
from fetal_mri_segmentation_tpu_torch.utils.device import resolve_device
from fetal_mri_segmentation_tpu_torch.utils.packing import (
    device_label_map, host_label_map)
from fetal_mri_segmentation_tpu_torch.utils.profiling import (
    request_of, span, tag)
from fetal_mri_segmentation_tpu_torch.utils.residency import (
    normalize_tta_mode, stage_to_device, transfer_prob, unpack_prob_f32)

TTA_MEMBERS = {"flips": 8, "permute": 48}


def flip_member(x: torch.Tensor, idx: int, axes=(1, 2, 3)) -> torch.Tensor:
    """Member ``idx`` of the 8 axis flips, bits (idx >> 2, idx >> 1, idx)
    over ``axes`` (an involution, so also its own inverse)."""
    dims = [a for a, bit in zip(axes, (idx >> 2 & 1, idx >> 1 & 1, idx & 1))
            if bit]
    return x.flip(dims) if dims else x


def tta_member(mode: str, x: torch.Tensor, idx: int,
               inverse: bool = False) -> torch.Tensor:
    """Member ``idx`` of the TTA group ``mode`` (or its inverse) applied to
    the spatial axes of an NDHWC batch."""
    if mode == "flips":
        return flip_member(x, idx)
    fn = reverse_permute_volume if inverse else permute_volume
    return fn(x.movedim(-1, 1), idx).movedim(1, -1)


class SlidingWindowPredictor:
    """Predictor for one volume geometry; reuse it across volumes."""

    def __init__(self, model, config, image_shape: Sequence[int],
                 overlap: int = 16, patch_batch_size: int = 8, device=None,
                 tta=False):
        self.device = (resolve_device(device) if device is not None
                       else next(model.parameters()).device)
        self.model = model.to(self.device).eval()
        self.config = config
        self.n_labels = config.n_labels
        self.image_shape = tuple(int(s) for s in image_shape)
        self.patch_shape = tuple(int(s) for s in config.patch_shape)
        self.patch_batch_size = int(patch_batch_size)
        self.tta_mode = normalize_tta_mode(tta)
        if self.tta_mode == "permute" and len(set(self.patch_shape)) != 1:
            raise ValueError(
                f"48-symmetry TTA requires cubic patches, got "
                f"{self.patch_shape} — use tta 'flips' (the 8-way flip "
                f"subgroup works for any patch shape)")

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
        # the patch batches this predictor predicts, and the group whose
        # accumulators it sums (parallel/distributed.py::
        # make_sharded_predictor); alone, all of them and none
        self.share = range(self.n_batches)
        self.group = None

    def _window(self, corner):
        return tuple(slice(c, c + s) for c, s in zip(corner, self.patch_shape))

    def _stage_volume(self, data_cdhw) -> torch.Tensor:
        """(C, D, H, W) host array or device tensor -> padded (D', H', W', C)
        device tensor in the model's compute dtype."""
        n_ch = self.config.nb_channels
        if (data_cdhw.ndim != 4 or data_cdhw.shape[0] != n_ch
                or tuple(data_cdhw.shape[-3:]) != self.image_shape):
            raise ValueError(
                f"predictor was built for (C={n_ch}, D, H, W) volumes with "
                f"image_shape={self.image_shape} but got a volume shaped "
                f"{tuple(data_cdhw.shape)} — rebuild the predictor (or "
                "resample the case to the training geometry, as "
                "preprocess_case does)")
        vol = stage_to_device(data_cdhw, self.model.dtype, self.device)
        total = [p - i for p, i in zip(self.padded_shape, self.image_shape)]
        pad = []
        for axis in (2, 1, 0):  # F.pad lists the last axis first
            before = int(self.pad_before[axis])
            pad += [before, total[axis] - before]
        vol = torch.nn.functional.pad(vol, pad)
        return vol.permute(1, 2, 3, 0).contiguous()

    def _apply(self, patches: torch.Tensor) -> torch.Tensor:
        """(P, d, h, w, C) -> fp32 (P, d, h, w, L), averaged over the TTA
        group's members when one is set (one forward of the batch each)."""
        if self.tta_mode is None:
            return self.model(patches).float()
        n = TTA_MEMBERS[self.tta_mode]
        acc = None
        for i in range(n):
            y = self.model(tta_member(self.tta_mode, patches, i).contiguous())
            y = tta_member(self.tta_mode, y.float(), i, inverse=True)
            acc = y if acc is None else acc + y
        return acc / n

    @property
    def n_batches(self) -> int:
        """The patch grid's batches of ``patch_batch_size`` corners."""
        return -(-len(self.corners) // self.patch_batch_size)

    def accumulate(self, vol: torch.Tensor, batches) -> torch.Tensor:
        """The Gaussian-weighted predictions of the patch batches numbered
        in ``batches`` (a range of ``range(n_batches)``), added into one
        fp32 (D', H', W', L) accumulator over the padded volume ``vol``
        (:meth:`_stage_volume`)."""
        acc = torch.zeros(self.padded_shape + (self.n_labels,),
                          dtype=torch.float32, device=self.device)
        P = self.patch_batch_size
        for i in batches:
            batch = self.corners[i * P:(i + 1) * P]
            with span("window.gather"):
                patches = torch.stack([vol[self._window(c)] for c in batch])
            with span("window.model"):
                preds = self._apply(patches)
            with span("window.overlap_add"):
                preds = preds * self.weight_map
                for c, pred in zip(batch, preds):
                    acc[self._window(c)] += pred
        return acc

    def _predict(self, data_cdhw, finish) -> torch.Tensor:
        """``finish`` of the fp32 probabilities (L, D, H, W) of one volume,
        on the device; enqueued without a synchronization, as one
        ``window.case`` span (a request of its own, or the one the volume
        was tagged with). The module is put in eval mode, on whole patches,
        here at every prediction (a train step on the same module leaves it
        in training mode, a depth-sharded one with a spatial group), as the
        JAX predictor applies with ``train=False`` whatever ran before."""
        with span("window.case", request=request_of(data_cdhw)):
            self.model.eval()
            set_spatial_group(self.model, None)
            with span("window.stage"):
                vol = self._stage_volume(data_cdhw)
            acc = self.accumulate(vol, self.share)
            if self.group is not None:
                torch.distributed.all_reduce(acc, group=self.group)
            with span("window.finish"):
                prob = acc / self.weight_sum
                crop = tuple(slice(int(b), int(b) + s) for b, s in
                             zip(self.pad_before, self.image_shape))
                return tag(finish(prob[crop].permute(3, 0, 1, 2)))

    @torch.inference_mode()
    def predict_probabilities(self, data_cdhw) -> torch.Tensor:
        """(C, D, H, W) -> fp32 probabilities (L, D, H, W) on the device;
        enqueued without a synchronization."""
        return self._predict(data_cdhw, lambda prob: prob)

    def __call__(self, data_cdhw) -> np.ndarray:
        """(C, D, H, W) -> probabilities (L, D, H, W), float32 on the host."""
        return self.predict_probabilities(data_cdhw).cpu().numpy()

    @torch.inference_mode()
    def predict_labels_async(self, data_cdhw,
                             threshold: float = 0.5) -> torch.Tensor:
        """Enqueue the label map of one volume and return it on the device
        without waiting (``utils/packing.py::device_label_map``); finish
        with :meth:`unpack_labels`."""
        return self._predict(data_cdhw, lambda prob: device_label_map(
            prob, threshold, self.n_labels, self.config.labels))

    def unpack_labels(self, out) -> np.ndarray:
        """An async label map on the host (the D2H copy waits for it)."""
        with span("window.fetch", request=request_of(out)):
            return host_label_map(out, self.n_labels, self.config.labels)

    def predict_labels(self, data_cdhw, threshold: float = 0.5) -> np.ndarray:
        """(C, D, H, W) -> label map (D, H, W), computed on the device.

        Binary: probability > threshold as uint8 0/1. Multi-class: argmax
        over channels mapped through ``config.labels`` (channel i ->
        labels[i]), 0 where no channel clears the threshold."""
        return self.unpack_labels(
            self.predict_labels_async(data_cdhw, threshold))

    @torch.inference_mode()
    def predict_prob_async(self, data_cdhw,
                           transfer_dtype: str = "float32") -> torch.Tensor:
        """Enqueue the probability map of one volume in ``transfer_dtype``
        (float32, float16 within 4.9e-4, or fixed-point uint8 / uint16
        within 2.0e-3 / 7.6e-6, ``utils/residency.py``) and return it on the
        device without waiting; finish with :meth:`unpack_prob`."""
        return self._predict(
            data_cdhw, lambda prob: transfer_prob(prob, transfer_dtype))

    def unpack_prob(self, out) -> np.ndarray:
        """An async probability map as float32 (L, D, H, W) on the host."""
        with span("window.fetch", request=request_of(out)):
            return unpack_prob_f32(out)
