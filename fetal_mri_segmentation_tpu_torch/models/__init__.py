"""Model family and factory of the port: ``UNet3D`` and ``Isensee2017``."""

from __future__ import annotations

import torch

from fetal_mri_segmentation_tpu_torch.config import check_supported
from fetal_mri_segmentation_tpu_torch.models.isensee2017 import Isensee2017
from fetal_mri_segmentation_tpu_torch.models.unet3d import UNet3D
from fetal_mri_segmentation_tpu_torch.utils.device import resolve_device

__all__ = ["Isensee2017", "UNet3D", "build_model"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(config, device="cuda"):
    """The configured model (``UNet3D`` or ``Isensee2017``, by
    ``config.model_name``) on ``device``, in eval mode.

    The card by default: on a machine without CUDA the default raises
    (``utils/device.py::resolve_device``); pass ``device="cpu"`` for the
    CPU. The Hopper kernels take bf16 only: on a CUDA device a float32
    config with ``use_pallas_conv`` or ``use_pallas_dec0`` on raises. As in
    the JAX package, Isensee2017's blocks always carry InstanceNorm, and the
    config's norm and deconvolution keys shape the U-Net only."""
    check_supported(config)
    dtype = _DTYPES[config.compute_dtype]
    if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
        for key in ("use_pallas_conv", "use_pallas_dec0"):
            if getattr(config, key):
                raise ValueError(
                    f"{key}=true selects a Hopper kernel, which runs in "
                    f"bf16 only; compute_dtype={config.compute_dtype!r}")
    common = dict(in_channels=config.nb_channels, n_labels=config.n_labels,
                  depth=config.depth, n_base_filters=config.n_base_filters,
                  activation_name=config.activation_name, dtype=dtype,
                  use_kernel_conv=config.use_pallas_conv,
                  use_kernel_dec0=config.use_pallas_dec0,
                  device=resolve_device(device))
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
