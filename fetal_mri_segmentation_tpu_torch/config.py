"""Experiment configuration: the JAX package's ``Config``, imported as it is.

``fetal_mri_segmentation_tpu.config`` is numpy-free plain Python, and the
JAX package's ``__init__`` imports only ``Config``, so this import pulls in
no jax. The port reads the same JSON files with the same key names.

Two keys change meaning on the card: ``use_pallas_conv`` selects the Hopper
conv kernel (``ops/conv3x3.py``) and ``use_pallas_dec0`` the Hopper fused
decoder kernel (``ops/dec0.py``). Both keep their names and their default
of false. :func:`check_supported` refuses what the port does not run yet
instead of ignoring it.
"""

from __future__ import annotations

from fetal_mri_segmentation_tpu.config import Config

__all__ = ["Config", "check_supported"]


def check_supported(config: Config) -> None:
    """Raise for configuration the port does not implement.

    ``fold_level0`` "auto", None and "off" all mean no fold: the JAX
    package folds only on a TPU (``models/layers.py::resolve_fold``), and
    the fold is a layout lever for the TPU's conv emitter with the same
    math as the plain path. An explicit fold tuple raises. More than one
    device raises (the port runs on one). The augmentations the port lacks
    are refused by ``training/train_step.py::make_train_step``, since a
    serving config may carry them."""
    if config.num_devices is not None and config.num_devices > 1:
        raise NotImplementedError(
            f"num_devices={config.num_devices}: the data-parallel mesh is "
            "not ported yet (DDP, ROADMAP.md queue 1, item 10)")
    if config.spatial_devices > 1:
        raise NotImplementedError(
            f"spatial_devices={config.spatial_devices}: depth-axis spatial "
            "sharding is not ported yet (ROADMAP.md queue 1, item 11)")
    if config.model_name != "unet":
        raise NotImplementedError(
            f"model_name={config.model_name!r}: only the unet is ported "
            "(Isensee2017 is ROADMAP.md queue 1, item 8)")
    for key in ("batch_normalization", "instance_normalization"):
        if getattr(config, key):
            raise NotImplementedError(
                f"{key}=true: conv-block norms are not ported yet "
                "(ROADMAP.md queue 1, item 2)")
    if config.deconvolution:
        raise NotImplementedError(
            "deconvolution=true: the transposed-conv UpConv is not ported "
            "yet (ROADMAP.md queue 1, item 2)")
    if config.fold_level0 not in (None, "auto", "off"):
        raise ValueError(
            f"fold_level0={config.fold_level0!r}: space-to-depth folding is "
            "a TPU layout lever and is not part of the port; use 'off'")
