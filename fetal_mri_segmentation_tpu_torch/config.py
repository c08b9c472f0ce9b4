"""Experiment configuration: a copy of the JAX package's ``Config``
(``fetal_mri_segmentation_tpu/config.py``), kept in the port so that the
port imports nothing of the JAX package. The same JSON files load with the
same key names, defaults and checks; a test holds the two classes' fields,
defaults and ``Config.load`` of every ``configs/*.json`` equal.

Two keys change meaning on the card: ``use_pallas_conv`` selects the Hopper
conv kernel (``ops/conv3x3.py``) and ``use_pallas_dec0`` the Hopper fused
decoder kernel (``ops/dec0.py``). Both keep their names and their default
of false. :func:`check_supported` refuses what the port does not run yet
instead of ignoring it. The port's functions read a config's attributes
only, so any object with these attributes (the JAX ``Config`` too) works.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Optional, Tuple

__all__ = ["Config", "check_supported"]


def _tup(x) -> Optional[Tuple[int, ...]]:
    return None if x is None else tuple(int(v) for v in x)


@dataclass
class Config:
    """Full experiment config, key names matching the reference train
    scripts (copy of ``fetal_mri_segmentation_tpu/config.py::Config``)."""

    # --- geometry -----------------------------------------------------------
    image_shape: Tuple[int, int, int] = (144, 144, 144)
    patch_shape: Optional[Tuple[int, int, int]] = (64, 64, 64)
    labels: Tuple[int, ...] = (1,)
    n_labels: int = 1
    all_modalities: Tuple[str, ...] = ("volume",)
    training_modalities: Optional[Tuple[str, ...]] = None  # default: all
    truth_channel: int = 1  # the truth "modality" slot (metadata only)

    # --- model --------------------------------------------------------------
    model_name: str = "unet"  # "unet" | "isensee"
    depth: Optional[int] = None  # None = model default (unet: 4, isensee: 5);
                                 # an explicit value is always honored as-is
    n_base_filters: int = 32
    deconvolution: bool = False
    batch_normalization: bool = False
    instance_normalization: bool = False
    activation_name: str = "sigmoid"  # "sigmoid" | "softmax"
    dropout_rate: float = 0.3  # isensee SpatialDropout3D rate
    n_segmentation_levels: int = 3  # isensee deep-supervision heads
    include_label_wise_dice_coefficients: bool = False  # per-label metrics
    compute_dtype: str = "bfloat16"  # bf16 compute, fp32 params
    use_pallas_conv: bool = False  # the port: the Hopper conv kernel
    use_pallas_dec0: bool = False  # the port: the Hopper fused decoder kernel
    fold_level0: Any = "auto"  # space-to-depth at the full-resolution level,
        # a TPU layout lever: "auto"/"off"/None run unfolded in the port; an
        # explicit [f1,f2,f3] (factors in {1,2}) is refused by check_supported
    fold_formulation: str = "dense"  # "parity" | "parity_batched" | "dense"
    remat: bool = False  # rematerialize the forward in the backward pass

    # --- optimization -------------------------------------------------------
    batch_size: int = 6
    validation_batch_size: Optional[int] = 12
    n_epochs: int = 500
    patience: int = 10  # LR-plateau patience (epochs)
    early_stop: int = 50  # early-stopping patience (epochs)
    initial_learning_rate: float = 5e-4
    learning_rate_drop: float = 0.5
    learning_rate_epochs: Optional[int] = None  # set: step decay, else plateau
    validation_split: float = 0.8

    # --- augmentation -------------------------------------------------------
    augment: bool = True
    flip: bool = True  # random axis flips
    permute: bool = True  # one of the 48 cube symmetries (cubic patches only)
    distort: Optional[float] = None  # scale-deviation factor, e.g. 0.25
    contrast: Optional[float] = 0.1  # fetal-fork intensity augmentation factor
    rotate: Optional[float] = None  # max rotation angle in degrees, e.g. 15

    # --- patch sampling -----------------------------------------------------
    validation_patch_overlap: int = 16
    training_patch_start_offset: Optional[Tuple[int, int, int]] = (16, 16, 16)
    skip_blank: bool = True
    gaussian_recon_sigma_scale: float = 0.125  # Gaussian importance-map sigma
                                               # as a fraction of patch size
    device_case_cache: str = "auto"  # "auto" | "on" | "off"

    # --- normalization ------------------------------------------------------
    normalization: str = "per_volume"  # "per_volume" | "global" | "windowed"

    # --- files --------------------------------------------------------------
    data_dir: Optional[str] = None  # per-case NIfTI folders for the builder
    data_file: str = "fetal_data.h5"
    model_file: str = "model.ckpt"
    training_file: str = "training_ids.pkl"
    validation_file: str = "validation_ids.pkl"
    training_log: str = "training.log"
    overwrite: bool = False

    # --- parallelism --------------------------------------------------------
    num_devices: Optional[int] = None  # None = all visible devices (DP mesh)
    spatial_devices: int = 1  # >1: volume depth sharded over devices

    # -------------------------------------------------------------------------
    def __post_init__(self):
        if self.depth is None:
            # Reference defaults: unet_model_3d(depth=4),
            # isensee2017_model(depth=5). Resolved here so an explicitly
            # configured depth is never reinterpreted downstream.
            self.depth = 5 if self.model_name == "isensee" else 4
        self.image_shape = _tup(self.image_shape)
        self.patch_shape = _tup(self.patch_shape)
        self.labels = _tup(self.labels)
        if self.labels is not None and len(self.labels) != self.n_labels:
            # a mismatch would make the multi-class label map silently wrong
            raise ValueError(
                f"len(labels)={len(self.labels)} must equal "
                f"n_labels={self.n_labels}; got labels={self.labels}")
        self.all_modalities = tuple(self.all_modalities)
        if self.training_modalities is None:
            self.training_modalities = self.all_modalities
        else:
            self.training_modalities = tuple(self.training_modalities)
        if self.training_patch_start_offset is not None:
            self.training_patch_start_offset = _tup(
                self.training_patch_start_offset)
        if self.device_case_cache not in ("auto", "on", "off"):
            raise ValueError(
                f"device_case_cache={self.device_case_cache!r} — must be "
                "'auto', 'on' or 'off'")
        if self.model_name not in ("unet", "isensee"):
            raise ValueError(f"model_name={self.model_name!r} — must be "
                             "'unet' or 'isensee'")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r} — must "
                             "be 'float32' or 'bfloat16'")
        if self.fold_level0 not in (None, "auto", "off"):
            try:
                f = tuple(int(v) for v in self.fold_level0)
            except (TypeError, ValueError):
                f = ()
            if len(f) != 3 or any(v not in (1, 2) for v in f):
                raise ValueError(f"fold_level0={self.fold_level0!r} — must "
                                 "be 'auto', 'off' or three per-axis "
                                 "factors in {1, 2}")
            self.fold_level0 = f
        if self.fold_formulation not in ("parity", "parity_batched",
                                         "dense"):
            raise ValueError(
                f"fold_formulation={self.fold_formulation!r} — must be "
                "'parity', 'parity_batched' or 'dense'")
        if self.normalization not in ("per_volume", "global", "windowed",
                                      "none", None):
            raise ValueError(
                f"normalization={self.normalization!r} — must be "
                "'per_volume', 'global', 'windowed' or 'none' "
                "(normalize_case semantics, data/normalize.py)")
        if self.batch_size < 1 or (self.validation_batch_size is not None
                                   and self.validation_batch_size < 1):
            raise ValueError(
                f"batch_size={self.batch_size} / validation_batch_size="
                f"{self.validation_batch_size} must be >= 1")
        if self.initial_learning_rate <= 0:
            raise ValueError(f"initial_learning_rate="
                             f"{self.initial_learning_rate} must be > 0")
        # patch geometry is deliberately not validated here: the grid math
        # raises a clear error at first use (ops/patches.py)

    @property
    def nb_channels(self) -> int:
        return len(self.training_modalities)

    @property
    def input_shape(self) -> Tuple[int, ...]:
        """Channels-first single-example shape, reference-compatible."""
        shape = (self.patch_shape if self.patch_shape is not None
                 else self.image_shape)
        return (self.nb_channels,) + tuple(shape)

    # --- JSON round-trip ----------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["nb_channels"] = self.nb_channels
        d["input_shape"] = list(self.input_shape)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        # derived keys that to_dict() adds; "_"-prefixed keys are comments
        derived = {"nb_channels", "input_shape"}
        unknown = sorted(k for k in d if k not in known | derived
                         and not k.startswith("_"))
        if unknown:
            # a silently dropped key would run the experiment with a default
            # the user thinks they overrode: warn, so forward-compatible
            # configs still load
            import difflib
            import warnings
            hints = []
            for k in unknown:
                close = difflib.get_close_matches(k, known, n=1)
                hints.append(f"{k!r}"
                             + (f" (did you mean {close[0]!r}?)"
                                if close else ""))
            warnings.warn("Config: ignoring unknown keys: "
                          + ", ".join(hints), stacklevel=2)
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def check_supported(config) -> None:
    """Raise for configuration the port does not implement.

    ``fold_level0`` "auto", None and "off" all mean no fold: the JAX
    package folds only on a TPU (``models/layers.py::resolve_fold``), and
    the fold is a layout lever for the TPU's conv emitter with the same
    math as the plain path. An explicit fold tuple raises. More than one
    device raises (the port runs on one)."""
    if config.num_devices is not None and config.num_devices > 1:
        raise NotImplementedError(
            f"num_devices={config.num_devices}: the data-parallel mesh is "
            "not ported yet (ROADMAP.md queue 1, DDP)")
    if config.spatial_devices > 1:
        raise NotImplementedError(
            f"spatial_devices={config.spatial_devices}: depth-axis spatial "
            "sharding is not ported yet (ROADMAP.md queue 1, spatial "
            "sharding over more than one device)")
    if config.fold_level0 not in (None, "auto", "off"):
        raise ValueError(
            f"fold_level0={config.fold_level0!r}: space-to-depth folding is "
            "a TPU layout lever and is not part of the port; use 'off'")
