"""Config-free migration from a reference whole-model Keras ``.h5`` to the
port.

Port of ``fetal_mri_segmentation_tpu/utils/keras_migrate.py``. The reference
resumes and predicts from ONE file with ZERO config (reference:
unet3d/training.py::load_old_model rebuilds the architecture from the
file's ``model_config`` attribute, then restores the weights and the
optimizer state). The readers and the architecture derivation
(:func:`read_keras_model_config`, :func:`read_keras_training_lr`,
:func:`derive_arch_from_model_config`, :func:`derive_arch_from_weight_list`)
are copies (``tests/test_torch_copies.py``);
:func:`derive_config_from_keras_h5` returns the port's ``Config`` and
:func:`load_old_model` the port's model and ``TrainState``, weights from
``utils/keras_import.py`` and Adam slots from ``utils/keras_opt.py``.

CLI surface: ``python -m fetal_mri_segmentation_tpu_torch.train
--from-keras model.h5`` continues training and ``python -m
fetal_mri_segmentation_tpu_torch.predict --from-keras model.h5`` predicts,
with no hand-written model config (data paths still come from
``--config``). Reading the file needs h5py; where it is missing both raise
an ``ImportError`` that names it.

Derivation contracts (the original's): architecture dispatch by strided
convs or ``Add`` layers (Isensee2017) against the plain U-Net; U-Net depth
from the max-pool count, Isensee depth from the strided convs; heads are
the bare 1^3 convs; the input geometry from the InputLayer; compute dtype
pinned to float32 (the continued-step parity is an fp32 property).
"""

from __future__ import annotations

import json
import warnings
from typing import List, Optional, Sequence, Tuple

from fetal_mri_segmentation_tpu_torch.config import Config
from fetal_mri_segmentation_tpu_torch.models import build_model
from fetal_mri_segmentation_tpu_torch.training.state import (
    create_train_state)
from fetal_mri_segmentation_tpu_torch.utils.keras_import import (
    import_keras_isensee_weights, import_keras_unet_weights,
    keras_state_dict, keras_weight_list_from_h5)
from fetal_mri_segmentation_tpu_torch.utils.keras_opt import (
    import_keras_adam_state, keras_adam_slots_from_h5)


def _require_h5py(path: str) -> None:
    """Reading a Keras ``.h5`` needs h5py: where it is missing, say so by
    name, as ``data/build.py`` does for an HDF5 dataset."""
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        raise ImportError(
            f"--from-keras {path}: reading a Keras .h5 needs h5py, which is "
            "not installed here. Import the file where h5py is installed "
            "(utils/keras_migrate.py::load_old_model), save the port's "
            "checkpoint, and train or predict from that") from e


_NORM_CLASSES = {"BatchNormalization", "InstanceNormalization",
                 "GroupNormalization"}


def read_keras_model_config(path: str) -> Optional[dict]:
    """The ``model_config`` JSON of a whole-model .h5, or None (weights-only
    saves and hand-rolled slot files have no such attribute)."""
    import h5py

    with h5py.File(path, "r") as f:
        raw = f.attrs.get("model_config")
    if raw is None:
        return None
    raw = raw.decode() if isinstance(raw, bytes) else raw
    return json.loads(raw)


def read_keras_training_lr(path: str) -> Optional[float]:
    """initial learning rate from the ``training_config`` attr, if saved."""
    import h5py

    with h5py.File(path, "r") as f:
        raw = f.attrs.get("training_config")
    if raw is None:
        return None
    raw = raw.decode() if isinstance(raw, bytes) else raw
    cfg = json.loads(raw).get("optimizer_config", {}).get("config", {})
    val = cfg.get("learning_rate", cfg.get("lr"))
    return float(val) if isinstance(val, (int, float)) else None


def _layer_seq(model_config: dict) -> List[dict]:
    cls = model_config.get("class_name")
    if cls not in ("Functional", "Model", "Sequential"):
        raise ValueError(
            f"model_config class_name={cls!r} — not a Keras "
            "Functional/Sequential graph (nested subclassed models cannot "
            "be reconstructed; re-save with the functional API)")
    layers = model_config.get("config", {}).get("layers")
    if not layers:
        raise ValueError("model_config has no config.layers list")
    return layers


def _is_instance_like(layer: dict) -> bool:
    """keras-contrib InstanceNormalization, or its modern stand-in
    GroupNormalization(groups=-1 / groups == channels)."""
    cls = layer.get("class_name", "")
    if cls == "InstanceNormalization":
        return True
    if cls == "GroupNormalization":
        return True  # per-channel groups is the only use in this lineage
    return False


def derive_arch_from_model_config(model_config: dict) -> dict:
    """Config field overrides reconstructed from a ``model_config`` dict.

    Returns Config keys (model_name, depth, n_base_filters, deconvolution,
    batch_normalization, instance_normalization, n_labels, activation_name,
    n_segmentation_levels, dropout_rate) plus the non-Config helpers
    ``in_channels`` and ``spatial_shape`` (None entries for dynamic dims).
    """
    layers = _layer_seq(model_config)
    by_cls = {}
    for layer in layers:
        by_cls.setdefault(layer.get("class_name", ""), []).append(layer)

    convs = by_cls.get("Conv3D", [])
    if not convs:
        raise ValueError("model_config contains no Conv3D layers — not a "
                         "reference 3D segmentation graph")

    # input geometry -------------------------------------------------------
    in_channels, spatial = None, None
    inputs = by_cls.get("InputLayer", [])
    data_format = convs[0]["config"].get("data_format", "channels_last")
    if inputs:
        icfg = inputs[0].get("config", {})
        bshape = icfg.get("batch_shape", icfg.get("batch_input_shape"))
        if bshape and len(bshape) == 5:
            dims = list(bshape[1:])
            if data_format == "channels_first":
                in_channels, spatial = dims[0], tuple(dims[1:])
            else:
                in_channels, spatial = dims[-1], tuple(dims[:-1])

    # weight-bearing sequence in topological order (the invariant the
    # weight importers match by: block convs are immediately followed by
    # their normalization; bare convs are heads)
    seq = [l for l in layers
           if l.get("class_name") in ("Conv3D", "Conv3DTranspose")
           or l.get("class_name") in _NORM_CLASSES]

    def filters(l):
        return int(l["config"]["filters"])

    def is_one_cubed(l):
        k = l["config"].get("kernel_size", 3)
        k = [k] * 3 if isinstance(k, int) else list(k)
        return all(int(v) == 1 for v in k)

    def is_strided(l):
        s = l["config"].get("strides", 1)
        s = [s] * 3 if isinstance(s, int) else list(s)
        return any(int(v) != 1 for v in s)

    strided = [l for l in convs if is_strided(l)]
    isensee = bool(strided) or "Add" in by_cls

    out = {"in_channels": in_channels, "spatial_shape": spatial,
           "n_base_filters": filters(convs[0])}

    # bare (head) convs: 1³ Conv3D whose successor in the weight-bearing
    # sequence is not a normalization — the same structural invariant
    # `import_keras_isensee_weights` matches blocks/heads by
    heads = [l for i, l in enumerate(seq)
             if l.get("class_name") == "Conv3D" and is_one_cubed(l)
             and not (i + 1 < len(seq)
                      and seq[i + 1].get("class_name") in _NORM_CLASSES)]

    if isensee:
        if not heads:
            raise ValueError(
                "Isensee-style graph (strided convs / residual adds) with "
                "no bare 1³ segmentation convs — cannot locate the "
                "deep-supervision heads")
        n_labels = filters(heads[-1])
        act = "sigmoid"
        for l in reversed(layers):
            if l.get("class_name") == "Activation":
                act = l["config"].get("activation", act)
                break
        out.update(
            model_name="isensee",
            depth=len(strided) + 1,
            n_segmentation_levels=len(heads),
            n_labels=n_labels,
            activation_name=act,
            deconvolution=bool(by_cls.get("Conv3DTranspose")),
            batch_normalization=False,
            instance_normalization=False,
        )
        drops = by_cls.get("SpatialDropout3D", [])
        if drops:
            out["dropout_rate"] = float(drops[0]["config"].get("rate", 0.3))
    else:
        # plain U-Net: head = last 1³ conv (normalized variants keep the
        # head bare, so `heads` found it; fallback = last conv)
        head = (heads or [l for l in convs if is_one_cubed(l)][-1:]
                or convs[-1:])[-1]
        act = head["config"].get("activation", "linear")
        if act in (None, "linear"):
            act = "sigmoid"
            for l in reversed(layers):
                if l.get("class_name") == "Activation":
                    act = l["config"].get("activation", act)
                    break
        out.update(
            model_name="unet",
            depth=len(by_cls.get("MaxPooling3D", [])) + 1,
            n_labels=filters(head),
            activation_name=act,
            deconvolution=bool(by_cls.get("Conv3DTranspose")),
            batch_normalization=bool(by_cls.get("BatchNormalization")),
            instance_normalization=any(
                _is_instance_like(l) for l in layers
                if l.get("class_name") in _NORM_CLASSES - {
                    "BatchNormalization"}),
        )
    return out


def derive_arch_from_weight_list(
        weights: Sequence[Tuple[str, list]]) -> dict:
    """Fallback for weights-only files (no ``model_config`` attr): recover
    the architecture from weight names and kernel shapes.

    The spatial input shape is NOT recoverable from conv kernels (they are
    resolution-agnostic) — ``spatial_shape`` comes back None and the base
    config's patch geometry is kept.
    """
    def is_norm(n):
        return "normalization" in n.lower()

    def is_transpose(n):
        return "transpose" in n.lower()

    convs = [(n, w) for n, w in weights
             if "conv" in n.lower() and not is_transpose(n)]
    if not convs:
        raise ValueError("weight list has no conv layers")
    norms = [(n, w) for n, w in weights if is_norm(n)]
    transposes = [(n, w) for n, w in weights if is_transpose(n)]
    first_kernel = convs[0][1][0]
    in_channels = int(first_kernel.shape[-2])
    n_base = int(first_kernel.shape[-1])

    instance_like = [n for n, _ in norms if "batch" not in n.lower()]
    out = {"in_channels": in_channels, "spatial_shape": None,
           "n_base_filters": n_base}

    if instance_like:
        # Isensee (the only instance-normalized reference graph): blocks =
        # conv+norm pairs, heads = the remaining bare convs.
        n_blocks = len(norms)
        n_heads = len(convs) - n_blocks
        if n_heads < 1 or (n_blocks + 3) % 6:
            raise ValueError(
                f"cannot reconstruct an Isensee2017 from {len(convs)} convs"
                f" + {n_blocks} norms (expected 6*depth-3 blocks plus "
                "bare segmentation heads)")
        out.update(model_name="isensee", depth=(n_blocks + 3) // 6,
                   n_segmentation_levels=n_heads,
                   n_labels=int(convs[-1][1][0].shape[-1]),
                   deconvolution=bool(transposes),
                   batch_normalization=False, instance_normalization=False)
    else:
        if norms:
            raise ValueError(
                "weights-only file with BatchNormalization layers: the "
                "batch-normalized U-Net cannot be imported (running "
                "moments are reconstruction-ambiguous) — save the model "
                "whole (model.save('model.h5')) instead")
        # plain U-Net: 4*depth - 1 convs (2/enc level + 2/dec level + head)
        if (len(convs) + 1) % 4:
            raise ValueError(
                f"cannot reconstruct a plain U-Net from {len(convs)} conv "
                "layers (expected 4*depth - 1)")
        out.update(model_name="unet", depth=(len(convs) + 1) // 4,
                   n_labels=int(convs[-1][1][0].shape[-1]),
                   deconvolution=bool(transposes),
                   batch_normalization=False, instance_normalization=False)
    return out


def derive_config_from_keras_h5(path: str, base=None, verbose: bool = True):
    """A `Config` whose MODEL fields are reconstructed from ``path``.

    ``base`` supplies everything the .h5 cannot know — data paths, training
    schedule, augmentation, batch sizes (defaults when None). Derived model
    fields OVERRIDE the base's; a silent conflict would train a different
    architecture than the file holds, so conflicts are reported.
    """
    _require_h5py(path)
    base = base if base is not None else Config()
    mc = read_keras_model_config(path)
    if mc is not None:
        arch = derive_arch_from_model_config(mc)
        source = "model_config"
    else:
        arch = derive_arch_from_weight_list(keras_weight_list_from_h5(path))
        source = "weight shapes (no model_config attr)"

    in_channels = arch.pop("in_channels", None)
    spatial = arch.pop("spatial_shape", None)

    d = base.to_dict()
    d.pop("nb_channels", None)
    d.pop("input_shape", None)
    conflicts = [f"{k}: {d[k]!r} -> {v!r}" for k, v in arch.items()
                 if k in d and d[k] != v]
    d.update(arch)
    d["compute_dtype"] = "float32"  # continued-step parity is fp32-exact

    if spatial is not None and all(s is not None for s in spatial):
        if base.patch_shape is not None \
                and tuple(base.patch_shape) != tuple(spatial):
            conflicts.append(
                f"patch_shape: {tuple(base.patch_shape)} -> {tuple(spatial)}")
        d["patch_shape"] = tuple(int(s) for s in spatial)
    if in_channels is not None and in_channels != len(
            d.get("training_modalities") or d.get("all_modalities") or ()):
        mods = tuple(f"channel_{i}" for i in range(in_channels))
        conflicts.append(
            f"modalities: {d.get('training_modalities')} -> {mods} "
            f"(the model takes {in_channels} input channel(s); rename via "
            "--config if your files use other modality names)")
        d["all_modalities"] = mods
        d["training_modalities"] = mods
    if d["n_labels"] != len(d.get("labels") or ()):
        d["labels"] = tuple(range(1, d["n_labels"] + 1))

    lr = read_keras_training_lr(path)
    if lr is not None:
        d["initial_learning_rate"] = lr

    if verbose:
        a = ", ".join(f"{k}={arch[k]}" for k in sorted(arch))
        print(f"[from-keras] {path}: derived from {source}: {a}")
        if conflicts:
            warnings.warn(
                "[from-keras] .h5 architecture overrides the config: "
                + "; ".join(conflicts), stacklevel=2)
    return Config.from_dict(d)


def load_old_model(path: str, config=None, with_optimizer="auto",
                   verbose: bool = True, derived: bool = False,
                   device="cuda"):
    """Reference ``training.py::load_old_model`` semantics for a Keras .h5:
    architecture + weights (+ optimizer state when present) from ONE file.

    Returns ``(model, state, config)``: the port's model on ``device`` with
    the imported weights and a ``TrainState`` over it; when the file is a
    whole-model save, its Adam moments, iteration count and learning rate
    are restored too (the first continued step equals a pure-Keras
    continuation). ``with_optimizer``: "auto" (import when the file has
    slots), True (require them), False (weights only, the predict path).
    ``derived``: ``config`` is already :func:`derive_config_from_keras_h5`'s
    result (the train entry derives early, so the dataset build sees the
    file's modalities and patch geometry)."""
    _require_h5py(path)
    if derived:
        if config is None:
            raise ValueError("derived=True requires the derived config")
        cfg = config
    else:
        cfg = derive_config_from_keras_h5(path, base=config, verbose=verbose)
    model = build_model(cfg, device)
    weights = keras_weight_list_from_h5(path)
    model.load_state_dict(keras_state_dict(cfg, weights))
    state = create_train_state(model, cfg)

    if with_optimizer:
        try:
            slots = keras_adam_slots_from_h5(path)
            if not slots.momentum:
                # compiled-but-never-trained saves carry an EMPTY
                # optimizer_weights group (the Keras optimizer builds its
                # slot variables lazily on the first train step)
                raise ValueError("optimizer_weights group is empty")
        except ValueError:
            if with_optimizer != "auto":
                raise
            if verbose:
                print(f"[from-keras] {path}: no optimizer state in the "
                      "file (weights-only or untrained save) — Adam "
                      "moments start fresh")
        else:
            importer = (import_keras_isensee_weights
                        if cfg.model_name == "isensee"
                        else import_keras_unet_weights)
            state = import_keras_adam_state(state, weights, slots, importer)
            if verbose:
                lr = slots.learning_rate
                print(f"[from-keras] restored Adam state: step "
                      f"{slots.iterations}"
                      + (f", lr {lr:g}" if lr is not None else ""))
    return model, state, cfg
