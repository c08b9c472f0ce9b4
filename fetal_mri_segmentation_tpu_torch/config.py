"""Experiment configuration: a copy of the JAX package's ``Config``
(``fetal_mri_segmentation_tpu/config.py``), kept in the port so that the
port imports nothing of the JAX package. The same JSON files load with the
same key names, defaults and checks; a test holds the two classes' fields,
defaults and ``Config.load`` of every ``configs/*.json`` equal.

Two keys change meaning on the card: ``use_pallas_conv`` selects the Hopper
conv kernel (``ops/conv3x3.py``) and ``use_pallas_dec0`` the Hopper fused
decoder kernel (``ops/dec0.py``). Both keep their names and their default
of false. :func:`check_supported` refuses early what the JAX package's
models refuse. The port's functions read a config's attributes
only, so any object with these attributes (the JAX ``Config`` too) works.

The port's own families add fields of their own at the end
(``PORT_ONLY``: MedNeXt's size and kernel), which the JAX ``Config`` does
not have; the port reads them only for ``model_name="mednext"``, and
:meth:`Config.to_dict` (so ``save``) writes them for that family only, so
that any other family's saved config loads in the JAX ``Config`` as
before.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Optional, Tuple

__all__ = ["Config", "PORT_ONLY", "check_interop", "check_supported"]

# the fields of the port's Config that the JAX package's does not have
PORT_ONLY = ("mednext_size", "mednext_kernel")


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
    model_name: str = "unet"  # "unet" | "isensee" | "swin_unetr" |
        # "mednext" (the port only: models/swin_unetr.py, models/mednext.py)
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
    fold_level0: Any = "auto"  # space-to-depth at the full-resolution level:
        # "auto"/"off"/None run unfolded in the port ("auto" folds on a TPU
        # only); an explicit [f1,f2,f3] (factors in {1,2}) folds
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

    # --- the port only (not in the JAX package's Config) --------------------
    mednext_size: str = "L"  # MedNeXt's published table: "S" | "B" | "M" | "L"
    mednext_kernel: int = 5  # MedNeXt's depthwise kernel: 3 | 5

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
        if self.model_name not in ("unet", "isensee", "swin_unetr",
                                   "mednext"):
            raise ValueError(f"model_name={self.model_name!r} — must be "
                             "'unet', 'isensee', 'swin_unetr' or 'mednext'")
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
        if self.model_name != "mednext":
            for k in PORT_ONLY:
                del d[k]
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
    """Raise, before a model or a dataset is built, for a configuration
    whose model the JAX package refuses, with its message, and for what
    the port's ``swin_unetr`` and ``mednext`` families do not take
    (:func:`_check_swin`, :func:`_check_mednext`).

    Every setting of the JAX ``Config`` is ported. ``fold_level0``: "auto",
    None and "off" run unfolded in the port ("auto" folds on a TPU only,
    ``models/layers.py::resolve_fold``); an explicit fold tuple folds the
    full-resolution level in every formulation, and a U-Net fold without
    the fused decoder, below depth 2 or with BatchNorm is refused
    (``models/layers.py::check_unet_fold``). ``num_devices`` above 1
    (data-parallel training, ``parallel/data_parallel.py``) and
    ``spatial_devices`` above 1 (depth-axis sharding on a hybrid mesh,
    ``parallel/spatial.py``) pass."""
    if config.model_name == "swin_unetr":
        _check_swin(config)
    if config.model_name == "mednext":
        _check_mednext(config)
    if config.model_name == "unet":
        from fetal_mri_segmentation_tpu_torch.models.layers import (
            check_unet_fold)

        check_unet_fold(config.fold_level0, not config.deconvolution,
                        config.depth, config.batch_normalization)


def _check_swin(config) -> None:
    """What ``SwinUNETR`` (``models/swin_unetr.py``) does not take: the
    Hopper kernel switches (its convs have no bias and run on cuDNN), an
    explicit fold, a depth-sharded mesh, a depth other than its four
    stages, a feature size (``n_base_filters``) that is not a multiple of
    12 (MONAI asserts it: every stage's heads divide its channels) and a
    patch not divisible by 32. The flax and Keras interop refuse it in
    :func:`check_interop`."""
    fs, shape = config.n_base_filters, config.patch_shape
    problems = [
        (config.use_pallas_conv or config.use_pallas_dec0,
         "use_pallas_conv / use_pallas_dec0 select the Hopper conv kernels, "
         "which take the U-Net families' conv blocks; swin_unetr's convs run "
         "on cuDNN: set both false"),
        (config.fold_level0 not in (None, "auto", "off"),
         f"fold_level0={config.fold_level0!r}: swin_unetr has no folded "
         "form: use 'auto' or 'off'"),
        (config.spatial_devices > 1,
         f"spatial_devices={config.spatial_devices}: swin_unetr runs whole "
         "patches on one device (no depth-sharded form): use 1"),
        (config.depth != 4,
         f"depth={config.depth}: swin_unetr has 4 stages (MONAI's depths "
         "(2, 2, 2, 2)): set depth 4"),
        (fs < 12 or fs % 12,
         f"n_base_filters={fs}: swin_unetr's feature size must be a "
         "multiple of 12 (MONAI's check: heads 3, 6, 12, 24 divide its "
         "stages' channels)"),
        (shape is not None and any(s % 32 for s in shape),
         f"patch_shape={shape}: swin_unetr needs each side divisible by 32 "
         "(the patch embedding and four merges halve it five times)"),
    ]
    for bad, message in problems:
        if bad:
            raise ValueError(message)


def _check_mednext(config) -> None:
    """What ``MedNeXt`` (``models/mednext.py``) does not take: the Hopper
    kernel switches (it has no dense 3^3 conv), an explicit fold, a
    depth-sharded mesh, a size or kernel the public code does not build,
    and a patch side not divisible by 16. On a CUDA device ``build_model``
    also refuses a ``n_base_filters`` that is not a multiple of 8; the flax
    and Keras interop refuse it (:func:`check_interop`), and so does
    ``utils/export.py::export_predictor`` (``predict --export``)."""
    shape = config.patch_shape
    problems = [
        (config.use_pallas_conv or config.use_pallas_dec0,
         "use_pallas_conv / use_pallas_dec0 select the Hopper conv kernels, "
         "which take the U-Net families' 3^3 conv blocks; mednext has none "
         "(its convs run on PyTorch's ops): set both false"),
        (config.fold_level0 not in (None, "auto", "off"),
         f"fold_level0={config.fold_level0!r}: mednext has no folded form: "
         "use 'auto' or 'off'"),
        (config.spatial_devices > 1,
         f"spatial_devices={config.spatial_devices}: mednext runs whole "
         "patches on one device (no depth-sharded form): use 1"),
        (config.mednext_size not in ("S", "B", "M", "L"),
         f"mednext_size={config.mednext_size!r}: the public sizes are 'S', "
         "'B', 'M' and 'L'"),
        (config.mednext_kernel not in (3, 5),
         f"mednext_kernel={config.mednext_kernel!r}: the public kernels are "
         "3 and 5"),
        (shape is not None and any(s % 16 for s in shape),
         f"patch_shape={shape}: mednext needs each side divisible by 16 "
         "(four down blocks halve it)"),
    ]
    for bad, message in problems:
        if bad:
            raise ValueError(message)


def check_interop(model_name: str) -> None:
    """Raise for a family with no flax or Keras counterpart: the JAX
    package's parameter layout (``utils/params.py``) and the Keras import
    and export (``utils/keras_*.py``) cover ``unet`` and ``isensee``."""
    if model_name in ("swin_unetr", "mednext"):
        raise ValueError(
            f"{model_name} has no flax or Keras counterpart: the JAX "
            "package's parameter layout and the Keras import and export "
            "cover 'unet' and 'isensee' only; save and load the port's own "
            "checkpoint")
