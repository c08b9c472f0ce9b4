"""Keras Adam optimizer-state interop (import AND export) for the port.

Port of ``fetal_mri_segmentation_tpu/utils/keras_opt.py``: a user migrating
a half-trained reference model continues with the same Adam moments, step
count and learning rate (reference: unet3d/training.py::load_old_model).
:class:`AdamSlots` and its readers (:func:`keras_adam_slots_from_h5`,
:func:`keras_adam_slots_from_model`, :func:`slots_as_weight_list`) are
copies (``tests/test_torch_copies.py``); :func:`import_keras_adam_state` /
:func:`export_keras_adam_state` move the slots between Keras and the
state of ``training/state.py::KerasAdam``.

What the mapping relies on (the original's):

- Keras's m and v slots are elementwise-aligned with their weight, so the
  weight importers and exporters, reused verbatim on slot lists, give the
  slots the weights' layout transforms (the Conv3DTranspose flip and
  channel swap included).
- Slots follow ``model.trainable_variables`` order, which is the weight
  list's traversal, so a flat slot list regroups into its per-layer arity.
- A legacy whole-model ``.h5`` keeps the state under
  ``optimizer_weights``; the Keras 3, TF2-era and TF1-era slot names are
  all read.
- Keras counts ``iterations`` as completed steps and bias-corrects with
  ``iterations + 1``; ``KerasAdam`` keeps the same count per parameter and
  corrects with ``count + 1`` after incrementing it, so the first
  continued step equals Keras's, with Keras's epsilon placement.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fetal_mri_segmentation_tpu_torch.utils.params import (
    flatten, flax_params, load_optax_adam_state, to_flax, unflatten)


@dataclass
class AdamSlots:
    """Flat Adam state in trainable-variable order."""
    iterations: int
    learning_rate: Optional[float]
    momentum: List[np.ndarray]
    velocity: List[np.ndarray]


def _names_from_group(grp) -> List[str]:
    names = grp.attrs.get("weight_names", None)
    if names is not None:
        return [n.decode() if isinstance(n, bytes) else str(n) for n in names]
    # no attr (hand-rolled files): walk datasets in insertion order
    out = []

    def visit(name, obj):
        import h5py
        if isinstance(obj, h5py.Dataset):
            out.append(name)
    grp.visititems(visit)
    return out


def keras_adam_slots_from_h5(path: str) -> AdamSlots:
    """Parse the ``optimizer_weights`` group of a legacy whole-model .h5."""
    import h5py

    with h5py.File(path, "r") as f:
        if "optimizer_weights" not in f:
            raise ValueError(
                f"{path}: no optimizer_weights group — the file was saved "
                "weights-only (model.save_weights); optimizer state needs a "
                "whole-model save (model.save('model.h5'), the reference's "
                "ModelCheckpoint output)")
        grp = f["optimizer_weights"]
        iterations, lr = 0, None
        momentum, velocity, unknown = [], [], []
        for name in _names_from_group(grp):
            arr = np.asarray(grp[name])
            base = name.rsplit(":", 1)[0]  # strip TF ':0' suffixes
            low = base.lower()
            if low.endswith("iteration") or low.endswith("iterations") \
                    or low.endswith("/iter") or low == "iter":
                # 'Adam/iter:0' is the TF2-era (tf.keras 2.4-2.10)
                # OptimizerV2 step-counter name; 'iterations' is Keras 2.2.
                iterations = int(arr)
            elif low.endswith("learning_rate") or low.endswith("/lr") \
                    or low == "lr" or low.endswith("_lr"):
                lr = float(arr)
            elif low.endswith("momentum") or low.endswith("/m") \
                    or "_momentum" in low:
                momentum.append(arr)
            elif low.endswith("velocity") or low.endswith("/v") \
                    or "_velocity" in low:
                velocity.append(arr)
            else:
                unknown.append(arr)
        if not momentum and not velocity and unknown:
            # TF1-era Keras 2.2 layout: unnamed slots, all m then all v
            if len(unknown) % 2:
                raise ValueError(
                    f"{path}: {len(unknown)} unrecognized optimizer slots "
                    "(odd count — cannot split into m/v halves)")
            half = len(unknown) // 2
            momentum, velocity = unknown[:half], unknown[half:]
        elif unknown:
            raise ValueError(
                f"{path}: {len(unknown)} optimizer slot(s) with "
                "unrecognized names alongside named momentum/velocity "
                "slots — mixed layout not supported")
        if lr is None and "training_config" in f.attrs:
            raw = f.attrs["training_config"]
            raw = raw.decode() if isinstance(raw, bytes) else raw
            opt_cfg = json.loads(raw).get("optimizer_config", {})
            cfg = opt_cfg.get("config", {})
            val = cfg.get("learning_rate", cfg.get("lr"))
            if isinstance(val, (int, float)):
                lr = float(val)
    if len(momentum) != len(velocity):
        raise ValueError(
            f"{path}: {len(momentum)} momentum vs {len(velocity)} velocity "
            "slots — not a plain-Adam optimizer state")
    return AdamSlots(iterations, lr, momentum, velocity)


def keras_adam_slots_from_model(keras_model) -> AdamSlots:
    """Extract Adam slots from a live compiled+built Keras 3 model."""
    opt = keras_model.optimizer
    slot_by_path = {v.path: np.asarray(v) for v in opt.variables}
    momentum, velocity = [], []
    for var in keras_model.trainable_variables:
        stem = f"{opt.name}/{var.path.replace('/', '_')}"
        try:
            momentum.append(slot_by_path[f"{stem}_momentum"])
            velocity.append(slot_by_path[f"{stem}_velocity"])
        except KeyError:
            raise ValueError(
                f"optimizer has no momentum/velocity slots for {var.path} "
                f"— not a built Adam optimizer (have: "
                f"{sorted(slot_by_path)[:6]}...)")
    return AdamSlots(int(np.asarray(opt.iterations)),
                     float(np.asarray(opt.learning_rate)),
                     momentum, velocity)


def slots_as_weight_list(keras_weights: Sequence[Tuple[str, list]],
                         flat: Sequence[np.ndarray]
                         ) -> List[Tuple[str, list]]:
    """Regroup a flat slot list into the weight list's per-layer arity.

    The result quacks like `keras_weight_list_from_model` output, so the
    existing weight importers map it — applying the identical layout
    transforms slots require.
    """
    total = sum(len(w) for _, w in keras_weights)
    if len(flat) != total:
        raise ValueError(
            f"slot count {len(flat)} != weight count {total} — optimizer "
            "state does not match this model's weight list")
    out, i = [], 0
    for name, weights in keras_weights:
        group = []
        for w in weights:
            s = flat[i]
            if tuple(np.shape(s)) != tuple(np.shape(w)):
                raise ValueError(
                    f"slot {i} shape {np.shape(s)} != weight shape "
                    f"{np.shape(w)} (layer {name}) — slot order does not "
                    "match the weight traversal")
            group.append(np.asarray(s))
            i += 1
        out.append((name, group))
    return out


def import_keras_adam_state(state, keras_weights, slots: AdamSlots,
                            importer: Callable):
    """Fill a ``TrainState``'s ``KerasAdam`` moments, step count and
    learning rate from Keras slots.

    ``importer`` is the matching weight importer
    (`import_keras_unet_weights` or `import_keras_isensee_weights`), reused
    verbatim on the slot lists so every layout transform the weights get,
    the slots get too; its template is the model's own params tree. Returns
    ``state`` (the parameters untouched: import those first). The step
    count becomes ``slots.iterations``; the learning rate stays where the
    slots do not carry one."""
    template = flax_params(state.model)
    mu = flatten(importer(template,
                          slots_as_weight_list(keras_weights,
                                               slots.momentum)))
    nu = flatten(importer(template,
                          slots_as_weight_list(keras_weights,
                                               slots.velocity)))
    lr = (slots.learning_rate if slots.learning_rate is not None
          else state.learning_rate)
    load_optax_adam_state(state.optimizer, state.model, slots.iterations,
                          mu, nu, lr)
    state.step = int(slots.iterations)
    return state


def _moments(state, key: str) -> dict:
    """One Adam moment of every parameter as a flax-layout tree (zeros for a
    parameter the optimizer has not stepped yet)."""
    moments = {}
    for name, p in state.model.named_parameters():
        slot = state.optimizer.state.get(p, {})
        moments[name] = slot.get(key, torch.zeros_like(p))
    return unflatten(to_flax(moments))


def export_keras_adam_state(state, keras_model, exporter: Callable) -> None:
    """Write a ``TrainState``'s Adam moments, step count and learning rate
    onto a compiled Keras model's optimizer, in place (reverse migration:
    ``keras_model.save(...)`` afterwards gives reference-era tooling a FULL
    resume .h5).

    ``exporter`` is the matching weight exporter
    (`export_keras_unet_weights` / `export_keras_isensee_weights`) run in
    slot-capture mode via its ``assign`` hook, so slots ride the same
    per-layer transforms as the weights.
    """
    opt = keras_model.optimizer
    if not getattr(opt, "built", False):
        opt.build(keras_model.trainable_variables)
    slot_by_path = {v.path: v for v in opt.variables}

    def assign_kind(kind: str):
        def assign(layer, arrays):
            tvars = [w for w in layer.weights if w.trainable]
            if len(tvars) != len(arrays):
                raise ValueError(
                    f"{layer.name}: {len(arrays)} slot arrays for "
                    f"{len(tvars)} trainable weights")
            for var, arr in zip(tvars, arrays):
                key = f"{opt.name}/{var.path.replace('/', '_')}_{kind}"
                if key not in slot_by_path:
                    raise ValueError(
                        f"optimizer has no slot {key!r} — not a built "
                        "Adam optimizer")
                slot_by_path[key].assign(np.asarray(arr, np.float32))
        return assign

    exporter(_moments(state, "mu"), keras_model,
             assign=assign_kind("momentum"))
    exporter(_moments(state, "nu"), keras_model,
             assign=assign_kind("velocity"))
    counts = {s["count"] for s in state.optimizer.state.values()} or {0}
    if len(counts) != 1:
        raise ValueError(f"parameters at different Adam steps {counts}: "
                         "Keras keeps one iteration count")
    opt.iterations.assign(counts.pop())
    opt.learning_rate.assign(state.learning_rate)
