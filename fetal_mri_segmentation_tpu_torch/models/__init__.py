"""Model families and factory of the port: ``UNet3D``, ``Isensee2017``,
``SwinUNETR`` and ``MedNeXt`` (the last two the port's only; the JAX
package has no such models)."""

from __future__ import annotations

import torch

from fetal_mri_segmentation_tpu_torch.config import check_supported
from fetal_mri_segmentation_tpu_torch.models.isensee2017 import Isensee2017
from fetal_mri_segmentation_tpu_torch.models.mednext import MedNeXt
from fetal_mri_segmentation_tpu_torch.models.swin_unetr import SwinUNETR
from fetal_mri_segmentation_tpu_torch.models.unet3d import UNet3D
from fetal_mri_segmentation_tpu_torch.utils.device import resolve_device

__all__ = ["Isensee2017", "MedNeXt", "SwinUNETR", "UNet3D", "build_model"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(config, device="cuda", bn_group=None):
    """The configured model (``UNet3D``, ``Isensee2017``, ``SwinUNETR`` or
    ``MedNeXt``, by ``config.model_name``) on ``device``, in eval mode.

    The card by default: on a machine without CUDA the default raises
    (``utils/device.py::resolve_device``); pass ``device="cpu"`` for the
    CPU. The Hopper kernels take bf16 only: on a CUDA device a float32
    config with ``use_pallas_conv`` or ``use_pallas_dec0`` on raises. As in
    the JAX package, Isensee2017's blocks always carry InstanceNorm, and the
    config's norm and deconvolution keys shape the U-Net only.
    ``fold_level0`` and ``fold_formulation`` pass through, as in the JAX
    package: an explicit fold tuple folds the full-resolution level
    (``models/layers.py::resolve_fold``), and a U-Net fold that the JAX
    model refuses raises here with its message.

    ``bn_group``: the process group of the data mesh, for sync BatchNorm
    under data parallelism (the JAX ``build_model``'s ``bn_axis_name``).

    ``SwinUNETR``: ``n_base_filters`` is MONAI's ``feature_size``, and its
    shift masks are made for ``patch_shape``. On a CUDA device its feature
    size must be a multiple of 24: the fused InstanceNorm kernel that its
    residual blocks' norms run takes channel counts in multiples of 8.

    ``MedNeXt``: ``n_base_filters`` is its base width (32 in every public
    size), ``mednext_size`` and ``mednext_kernel`` pick the public table
    and the depthwise kernel. On a CUDA device the base width must be a
    multiple of 8, for the same fused norm."""
    check_supported(config)
    dtype = _DTYPES[config.compute_dtype]
    if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
        for key in ("use_pallas_conv", "use_pallas_dec0"):
            if getattr(config, key):
                raise ValueError(
                    f"{key}=true selects a Hopper kernel, which runs in "
                    f"bf16 only; compute_dtype={config.compute_dtype!r}")
    if config.model_name == "swin_unetr":
        if (torch.device(device).type == "cuda"
                and config.n_base_filters % 8):
            raise ValueError(
                f"n_base_filters={config.n_base_filters}: on a CUDA device "
                "SwinUNETR's feature size must be a multiple of 24 (MONAI's "
                "12, and the fused InstanceNorm kernel's 8)")
        return SwinUNETR(
            in_channels=config.nb_channels, n_labels=config.n_labels,
            feature_size=config.n_base_filters,
            activation_name=config.activation_name, dtype=dtype,
            device=resolve_device(device),
            patch_shape=config.patch_shape).eval()
    if config.model_name == "mednext":
        if (torch.device(device).type == "cuda"
                and config.n_base_filters % 8):
            raise ValueError(
                f"n_base_filters={config.n_base_filters}: on a CUDA device "
                "MedNeXt's base width must be a multiple of 8 (the fused "
                "InstanceNorm kernel's channel step)")
        return MedNeXt(
            in_channels=config.nb_channels, n_labels=config.n_labels,
            n_base_filters=config.n_base_filters, size=config.mednext_size,
            kernel=config.mednext_kernel,
            activation_name=config.activation_name, dtype=dtype,
            device=resolve_device(device)).eval()
    common = dict(in_channels=config.nb_channels, n_labels=config.n_labels,
                  depth=config.depth, n_base_filters=config.n_base_filters,
                  activation_name=config.activation_name, dtype=dtype,
                  use_kernel_conv=config.use_pallas_conv,
                  use_kernel_dec0=config.use_pallas_dec0,
                  device=resolve_device(device), bn_group=bn_group,
                  fold_level0=config.fold_level0,
                  fold_formulation=config.fold_formulation)
    if config.model_name == "isensee":
        model = Isensee2017(
            dropout_rate=config.dropout_rate,
            n_segmentation_levels=config.n_segmentation_levels, **common)
    else:
        model = UNet3D(
            deconvolution=config.deconvolution,
            batch_normalization=config.batch_normalization,
            instance_normalization=config.instance_normalization, **common)
    return model.eval()
