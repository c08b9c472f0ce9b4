"""Direct whole-volume prediction on one device (port of the single-device
part of ``fetal_mri_segmentation_tpu/parallel/spatial.py``:
``SpatialPredictor`` on a one-device mesh and ``make_direct_predictor``).

The fully convolutional net runs once over the whole volume: no patch
grid, no overlap recompute, no seams. Volume dims must be divisible by
2^(depth-1). Optional volume-level test-time augmentation averages the
symmetry group over the whole volume ("flips": the 8 axis flips, any
shape; "permute": the 48 cube symmetries, cubic volumes only), with the
members batched ``tta_chunk`` at a time into one forward each.

Depth-axis sharding over several devices and the GSPMD train and eval
steps wait for multi-GPU work (ROADMAP.md queue 1, "DDP" and "spatial
sharding over more than one device"); the entry points refuse ``--spatial-devices`` above 1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (
    flip_member)
from fetal_mri_segmentation_tpu_torch.ops.augment import (
    PERMUTATION_KEYS, permute_volume, reverse_permute_volume)
from fetal_mri_segmentation_tpu_torch.utils.device import resolve_device
from fetal_mri_segmentation_tpu_torch.utils.packing import (
    device_label_map, host_label_map)
from fetal_mri_segmentation_tpu_torch.utils.residency import (
    normalize_tta_mode, stage_to_device, transfer_prob, unpack_prob_f32)


class AsyncLabels:
    """Async label-map handle: the device label map bound to the volume
    shape it was dispatched for."""

    __slots__ = ("device_array", "shape")

    def __init__(self, device_array, shape):
        self.device_array = device_array
        self.shape = tuple(shape)


class SpatialPredictor:
    """Whole-volume predictor: one forward over the full volume (or one per
    chunk of TTA members). Duck-types ``SlidingWindowPredictor``'s serving
    surface: ``__call__``, ``predict_probabilities``, ``predict_labels``,
    ``predict_labels_async`` / ``unpack_labels`` and ``predict_prob_async``
    / ``unpack_prob``."""

    def __init__(self, model, config, *, tta=False,
                 tta_chunk: Optional[int] = None, device=None):
        self.device = (resolve_device(device) if device is not None
                       else next(model.parameters()).device)
        self.model = model.to(self.device).eval()
        self.config = config
        self.n_labels = config.n_labels
        self.tta_mode = normalize_tta_mode(tta)
        # defaults of the JAX predictor: permute in chunks of 8 of the 48
        # symmetries, flips in chunks of 2 of the 8 flips
        members = 8 if self.tta_mode == "flips" else 48
        if tta_chunk is None:
            tta_chunk = 8 if self.tta_mode == "permute" else 2
        if tta_chunk < 1 or members % tta_chunk:
            raise ValueError(f"tta_chunk={tta_chunk} must divide {members}")
        self.tta_chunk = tta_chunk

    # ------------------------------------------------------------------
    def _forward(self, xs: torch.Tensor) -> torch.Tensor:
        """(N, D, H, W, C) -> fp32 (N, D, H, W, L)."""
        return self.model(xs.contiguous()).float()

    def _probs(self, vol: torch.Tensor) -> torch.Tensor:
        """(C, D, H, W) device volume -> fp32 (L, D, H, W)."""
        x = vol.permute(1, 2, 3, 0)[None]                 # (1, D, H, W, C)
        if self.tta_mode is None:
            return self._forward(x)[0].permute(3, 0, 1, 2)
        if self.tta_mode == "flips":
            acc = None
            for start in range(0, 8, self.tta_chunk):
                members = range(start, start + self.tta_chunk)
                ys = self._forward(torch.cat([flip_member(x, i)
                                              for i in members]))
                for i, y in zip(members, ys):
                    y = flip_member(y[None], i)[0]
                    acc = y if acc is None else acc + y
            return (acc / 8).permute(3, 0, 1, 2)
        n = len(PERMUTATION_KEYS)
        acc = None
        for start in range(0, n, self.tta_chunk):
            members = range(start, start + self.tta_chunk)
            xs = torch.stack([permute_volume(vol, i) for i in members])
            ys = self._forward(xs.movedim(1, -1))         # (chunk, ..., L)
            for i, y in zip(members, ys):
                y = reverse_permute_volume(y.movedim(-1, 0), i)
                acc = y if acc is None else acc + y
        return acc / n

    # ------------------------------------------------------------------
    def _check_volume(self, full_shape):
        """A (C, D, H, W) volume with the config's channel count."""
        n_ch = self.config.nb_channels
        if len(full_shape) != 4 or full_shape[0] != n_ch:
            raise ValueError(
                f"expected a (C={n_ch}, D, H, W) volume "
                f"(training_modalities="
                f"{tuple(self.config.training_modalities)}); got shape "
                f"{tuple(full_shape)} — stack the case's modalities on "
                "axis 0 (as preprocess_case does)")
        self._check_shape(tuple(full_shape[1:]))

    def _check_shape(self, shape):
        """Fail loudly where the whole-volume forward cannot run: spatial
        dims must survive depth-1 halvings, and 48-symmetry TTA needs a
        cube."""
        depth = getattr(self.config, "depth", None)
        if depth is None:
            raise ValueError(
                "config.depth is required for whole-volume inference — the "
                "divisibility guard needs the model's pooling depth")
        d_div = 2 ** (int(depth) - 1)
        for i, s in enumerate(shape):
            if s % d_div != 0:
                raise ValueError(
                    f"whole-volume inference needs every spatial dim "
                    f"divisible by 2^(depth-1)={d_div}; volume shape "
                    f"{tuple(shape)} dim {i} is {s}. Use the sliding-window "
                    f"predictor (patching) for this geometry.")
        if self.tta_mode == "permute" and len(set(shape)) != 1:
            raise ValueError(
                f"48-symmetry TTA (permute) on the whole-volume predictor "
                f"requires a CUBIC volume, got {tuple(shape)} — use "
                f"tta='flips' (the 8-way flip subgroup works for any shape)")

    def _stage(self, data_cdhw) -> torch.Tensor:
        self._check_volume(tuple(data_cdhw.shape))
        return stage_to_device(data_cdhw, self.model.dtype, self.device)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def predict_probabilities(self, data_cdhw) -> torch.Tensor:
        """(C, D, H, W) -> fp32 probabilities (L, D, H, W) on the device;
        enqueued without a synchronization. The module is put in eval
        mode at every prediction: a train step on the same module leaves it
        in training mode."""
        self.model.eval()
        return self._probs(self._stage(data_cdhw))

    def __call__(self, data_cdhw) -> np.ndarray:
        """(C, D, H, W) -> probabilities (L, D, H, W), float32 on the host."""
        return self.predict_probabilities(data_cdhw).cpu().numpy()

    @torch.inference_mode()
    def predict_labels_async(self, data_cdhw,
                             threshold: float = 0.5) -> AsyncLabels:
        """Enqueue the label map without waiting; finish with
        :meth:`unpack_labels`."""
        prob = self.predict_probabilities(data_cdhw)
        return AsyncLabels(device_label_map(prob, threshold, self.n_labels,
                                            self.config.labels),
                           prob.shape[1:])

    def unpack_labels(self, out) -> np.ndarray:
        """An async result (an :class:`AsyncLabels` or a device label map)
        on the host."""
        if isinstance(out, AsyncLabels):
            out = out.device_array
        return host_label_map(out, self.n_labels, self.config.labels)

    def predict_labels(self, data_cdhw, threshold: float = 0.5) -> np.ndarray:
        return self.unpack_labels(
            self.predict_labels_async(data_cdhw, threshold))

    @torch.inference_mode()
    def predict_prob_async(self, data_cdhw,
                           transfer_dtype: str = "float32") -> torch.Tensor:
        """Enqueue the probability map in ``transfer_dtype`` (float32,
        float16, uint8 or uint16) without waiting; finish with
        :meth:`unpack_prob`."""
        return transfer_prob(self.predict_probabilities(data_cdhw),
                             transfer_dtype)

    def unpack_prob(self, out) -> np.ndarray:
        """An async probability map as float32 (L, D, H, W) on the host."""
        return unpack_prob_f32(out)


def make_direct_predictor(model, config, tta=False,
                          tta_chunk: Optional[int] = None,
                          device=None) -> SpatialPredictor:
    """The single-device direct whole-volume predictor (see
    :class:`SpatialPredictor`)."""
    return SpatialPredictor(model, config, tta=tta, tta_chunk=tta_chunk,
                            device=device)

