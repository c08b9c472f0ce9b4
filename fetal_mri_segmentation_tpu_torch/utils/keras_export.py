"""Export the port's weights back to a Keras model (reverse migration).

Port of ``fetal_mri_segmentation_tpu/utils/keras_export.py``: the same
traversal and layout transforms (the Conv3DTranspose spatial flip and
channel swap included), applied to the flax-layout tree that
``utils/params.py::to_flax`` makes from the port's module, the exact
inverse of the ``from_flax`` the importer goes through. Both functions
SET weights in place on an already-built twin Keras model (the user's own
reference graph); ``keras_model.save(...)`` afterwards produces the
``.h5``. The functions need only the Keras model's ``layers`` with
``get_weights`` / ``set_weights`` (and ``name``).
"""

from __future__ import annotations

from typing import List

import numpy as np
from torch import nn

from fetal_mri_segmentation_tpu_torch.utils.keras_import import (
    _as_numpy, _is_conv, _is_norm, _isensee_param_order, _unet_param_order)
from fetal_mri_segmentation_tpu_torch.utils.params import flax_params


def _weighted_layers(keras_model) -> List[object]:
    return [l for l in keras_model.layers if l.get_weights()]


def _set_weights(layer, arrays) -> None:
    layer.set_weights([np.asarray(a, np.float32) for a in arrays])


def _params(model) -> dict:
    """The flax-layout params tree of a port module, or ``model`` itself
    where it is one already (Adam's moments, ``utils/keras_opt.py``)."""
    if isinstance(model, nn.Module):
        return flax_params(model)
    return _as_numpy(model)


def export_keras_unet_weights(model, keras_model,
                              assign=_set_weights) -> None:
    """Write a ``UNet3D``'s weights onto a twin Keras plain-UNet, in place.

    ``model``: the port's ``UNet3D`` (no batch/instance norm — mirror of
    `import_keras_unet_weights`'s scope), or its params as a flax-layout
    tree. ``assign(layer, arrays)`` receives the layout-transformed arrays
    per layer; the default sets the layer weights, `utils/keras_opt.py`
    redirects the same traversal at Adam slot variables.
    """
    params = _params(model)
    for k, sub in params.items():
        if isinstance(sub, dict) and ("bn" in sub or "in" in sub):
            raise ValueError(
                f"{k}: params contain normalization variables — this "
                f"plain-UNet exporter maps conv weights only")
    order = _unet_param_order(params)

    layers = _weighted_layers(keras_model)
    if any(_is_norm(type(l).__name__) for l in layers):
        raise ValueError(
            "keras model contains normalization layers — not a plain-UNet "
            "twin; for Isensee use export_keras_isensee_weights")
    transpose_q = [l for l in layers
                   if "transpose" in type(l).__name__.lower()]
    conv_q = [l for l in layers if _is_conv(type(l).__name__)]
    n_deconv = sum(1 for k in order if "deconv" in params.get(k, {}))
    if len(transpose_q) != n_deconv or len(conv_q) != len(order) - n_deconv:
        raise ValueError(
            f"layer count mismatch: keras model has {len(conv_q)} conv + "
            f"{len(transpose_q)} transpose layers, our UNet3D provides "
            f"{len(order) - n_deconv} + {n_deconv} ({order}) — check "
            f"depth/deconvolution settings")

    for target in order:
        sub = params[target]
        if "deconv" in sub:
            layer = transpose_q.pop(0)
            k = np.asarray(sub["deconv"]["kernel"], np.float32)
            # inverse of the import transform (keras (k..., out, in) with
            # mirrored taps): undo the spatial flip, then swap the channel
            # axes back.
            kernel = np.transpose(k[::-1, ::-1, ::-1], (0, 1, 2, 4, 3))
            bias = sub["deconv"]["bias"]
        else:
            layer = conv_q.pop(0)
            payload = sub if "kernel" in sub else sub["conv"]
            kernel, bias = payload["kernel"], payload["bias"]
        want = layer.get_weights()[0].shape
        if tuple(kernel.shape) != tuple(want):
            raise ValueError(
                f"{target}: kernel shape {kernel.shape} != keras layer "
                f"{layer.name} expects {tuple(want)}")
        assign(layer, [np.ascontiguousarray(kernel, np.float32),
                       np.asarray(bias, np.float32)])


def export_keras_isensee_weights(model, keras_model,
                                 assign=_set_weights) -> None:
    """Write an ``Isensee2017``'s weights onto a twin Keras graph, in place.

    ``model`` as in `export_keras_unet_weights`. Pairs each Keras conv with
    its immediately-following InstanceNorm (GroupNormalization(groups=-1))
    as one conv block and treats bare 1^3 convs as segmentation heads — the
    same structural invariant `import_keras_isensee_weights` relies on.
    ``assign`` as in `export_keras_unet_weights`.
    """
    params = _params(model)
    block_order, head_order = _isensee_param_order(params)

    layers = _weighted_layers(keras_model)
    blocks_q, heads_q = [], []
    i = 0
    while i < len(layers):
        name = type(layers[i]).__name__
        if _is_conv(name):
            if (i + 1 < len(layers)
                    and _is_norm(type(layers[i + 1]).__name__)):
                blocks_q.append((layers[i], layers[i + 1]))
                i += 2
                continue
            heads_q.append(layers[i])
        elif not _is_norm(name):
            raise ValueError(
                f"unexpected weight-bearing keras layer {layers[i].name} "
                f"({name}) — not an Isensee2017 twin")
        i += 1

    if len(blocks_q) != len(block_order) or len(heads_q) != len(head_order):
        raise ValueError(
            f"layer count mismatch: keras model has {len(blocks_q)} "
            f"conv+norm blocks and {len(heads_q)} bare segmentation convs, "
            f"our Isensee2017 provides {len(block_order)} blocks and "
            f"{len(head_order)} heads — check depth/n_segmentation_levels")

    for target, (conv_l, norm_l) in zip(block_order, blocks_q):
        sub = params[target]
        kernel = np.ascontiguousarray(sub["conv"]["kernel"], np.float32)
        if tuple(kernel.shape) != tuple(conv_l.get_weights()[0].shape):
            raise ValueError(
                f"{target}: kernel shape {kernel.shape} != keras layer "
                f"{conv_l.name} expects "
                f"{tuple(conv_l.get_weights()[0].shape)}")
        assign(conv_l, [kernel,
                        np.asarray(sub["conv"]["bias"], np.float32)])
        assign(norm_l, [np.asarray(sub["in"]["scale"], np.float32),
                        np.asarray(sub["in"]["bias"], np.float32)])
    for target, layer in zip(head_order, heads_q):
        sub = params[target]
        assign(layer, [np.ascontiguousarray(sub["kernel"], np.float32),
                       np.asarray(sub["bias"], np.float32)])
