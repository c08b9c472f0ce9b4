"""Ingest resampling and normalization on the device (port of
``fetal_mri_segmentation_tpu/ops/resample.py``).

The host path (``utils/geometry.py``, scipy's ``ndimage.zoom`` with
``grid_mode=True`` and ``mode="nearest"``, then ``data/normalize.py``)
costs a few hundred milliseconds of one CPU core per case. Here the host
only reads the NIfTI files and crops the background; the cropped volumes
are padded to a shape bucket (the next multiple of 16 per axis, so the
caching allocator sees few distinct shapes), copied to the device once
from pinned memory, resampled there by three separable 1-D gathers and
normalized there in fp32. The result is a device tensor that the
predictors consume in place.

The 1-D resample follows scipy's ``grid_mode=True`` coordinates
``src = (i + 0.5) * n_in / n_out - 0.5``, clamped to the true extent
(``mode="nearest"``): order 1 is a linear interpolation between the two
neighbours, order 0 takes scipy's ``floor(src + 0.5)`` knot. Indices are
made on the device from host integers, so no step copies to or from the
host. Parity with scipy is floating-point level, not bit level.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from fetal_mri_segmentation_tpu_torch.utils.device import resolve_device

BUCKET_STEP = 16


def bucket_shape(shape: Sequence[int], step: int = BUCKET_STEP
                 ) -> Tuple[int, ...]:
    """Round each axis up to the next multiple of ``step``."""
    return tuple(int(-(-int(s) // step) * step) for s in shape)


def _axis_resample(vol: torch.Tensor, axis: int, n_true: int, n_out: int,
                   order: int) -> torch.Tensor:
    """Resample axis ``axis`` of ``vol`` from its true extent ``n_true``
    (the leading part of the padded axis) to ``n_out`` samples."""
    src = ((torch.arange(n_out, dtype=torch.float32, device=vol.device)
            + 0.5) * (float(n_true) / n_out) - 0.5)
    src = src.clamp(0.0, float(n_true - 1))  # mode="nearest" edge extension
    top = vol.shape[axis] - 1
    if order == 0:
        idx = torch.floor(src + 0.5).long().clamp(0, n_true - 1)
        return vol.index_select(axis, idx)
    i0 = torch.floor(src).long().clamp(max=n_true - 2).clamp(min=0)
    w = (src - i0.float()).clamp(0.0, 1.0)
    view = [1] * vol.dim()
    view[axis] = n_out
    w = w.view(view)
    x0 = vol.index_select(axis, i0.clamp(max=top))
    x1 = vol.index_select(axis, (i0 + 1).clamp(max=top))
    return x0 * (1.0 - w) + x1 * w


def resample_3d(vol: torch.Tensor, true_shape: Sequence[int],
                out_shape: Sequence[int], order: int = 1) -> torch.Tensor:
    """(..., Dp, Hp, Wp) padded -> (..., *out_shape). The last three axes
    are spatial, with the data in ``[:true_shape[a]]`` of each; the padding
    beyond is never read."""
    for a in range(3):
        vol = _axis_resample(vol, vol.dim() - 3 + a, int(true_shape[a]),
                             int(out_shape[a]), order)
    return vol


def _percentiles(flat: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """Per-row percentiles of (C, N) with numpy's "linear" rule, from one
    sort (``torch.quantile`` refuses rows longer than 2^24)."""
    n = flat.shape[1]
    ordered = flat.sort(dim=1).values
    out = []
    for q in qs:
        pos = q / 100.0 * (n - 1)
        i0 = int(np.floor(pos))
        i1 = min(i0 + 1, n - 1)
        frac = pos - i0
        out.append(ordered[:, i0] * (1.0 - frac) + ordered[:, i1] * frac)
    return torch.stack(out)  # (len(qs), C)


def _normalize_dev(data: torch.Tensor, mode: Optional[str],
                   mean: Optional[torch.Tensor], std: Optional[torch.Tensor],
                   lower_percentile: float, upper_percentile: float
                   ) -> torch.Tensor:
    """Device twin of ``data/normalize.py::normalize_case`` over a
    (C, D, H, W) fp32 volume."""
    if mode is None or mode == "none":
        return data
    view = (-1, 1, 1, 1)
    if mode == "global":
        s = std.view(view)
        return (data - mean.view(view)) / torch.where(
            s == 0, torch.ones_like(s), s)
    if mode == "windowed":
        lo, hi = _percentiles(data.reshape(data.shape[0], -1),
                              (lower_percentile, upper_percentile))
        data = torch.minimum(torch.maximum(data, lo.view(view)),
                             hi.view(view))
    elif mode != "per_volume":
        raise ValueError(f"unknown normalization mode: {mode!r}")
    m = data.mean(dim=(1, 2, 3), keepdim=True)
    s = data.std(dim=(1, 2, 3), correction=0, keepdim=True)
    return (data - m) / torch.where(s == 0, torch.ones_like(s), s)


class DevicePreprocessor:
    """Crop on the host, zoom and normalize on the device, for serving.

    One instance per (out_shape, normalization). ``global`` mode takes the
    training set's (mean, std) as ``moments``
    (``inference/predict.py::load_global_moments`` reads them from the
    dataset).
    ``transfer_dtype`` bfloat16 halves the raw volume's upload at about
    0.4% relative intensity error before normalization; ``compute_dtype``
    is the dtype handed to the predictor (the model's, so no cast runs
    later). ``device`` is the card unless the caller asks for the CPU."""

    def __init__(self, image_shape: Sequence[int], normalization: str,
                 moments=None, lower_percentile: float = 1.0,
                 upper_percentile: float = 99.0,
                 compute_dtype: torch.dtype = torch.float32,
                 transfer_dtype: torch.dtype = torch.float32,
                 device="cuda"):
        self.image_shape = tuple(int(s) for s in image_shape)
        self.normalization = normalization
        self.device = resolve_device(device)
        self._transfer_dtype = transfer_dtype
        self._dtype = compute_dtype
        if normalization == "global":
            if moments is None:
                raise ValueError(
                    "DevicePreprocessor(normalization='global') needs the "
                    "training dataset's (mean, std)")
            # host copies validate preprocess_case's moments without a
            # device-to-host read in the serving loop
            self._host_moments = (np.asarray(moments[0], np.float32),
                                  np.asarray(moments[1], np.float32))
            self._mean, self._std = (
                torch.as_tensor(m, dtype=torch.float32).reshape(-1).to(
                    self.device) for m in self._host_moments)
        else:
            self._mean = self._std = self._host_moments = None
        self._lo, self._hi = float(lower_percentile), float(upper_percentile)

    def __call__(self, arrays: Sequence[np.ndarray]) -> torch.Tensor:
        """A list of C cropped (d, h, w) volumes (one per modality, equal
        shapes) -> the normalized (C, *image_shape) volume on the device,
        enqueued without a synchronization."""
        true = tuple(int(s) for s in arrays[0].shape)
        for a in arrays:
            if tuple(a.shape) != true:
                raise ValueError("modalities must share the crop shape: "
                                 f"{tuple(a.shape)} vs {true}")
        bucket = bucket_shape(true)
        pin = self.device.type == "cuda"
        stack = torch.zeros((len(arrays),) + bucket,
                            dtype=self._transfer_dtype, pin_memory=pin)
        for c, a in enumerate(arrays):
            stack[c, :true[0], :true[1], :true[2]] = torch.from_numpy(
                np.asarray(a, np.float32))
        padded = stack.to(self.device, non_blocking=pin).float()
        v = resample_3d(padded, true, self.image_shape, order=1)
        v = _normalize_dev(v, self.normalization, self._mean, self._std,
                           self._lo, self._hi)
        return v.to(self._dtype)
