"""Import reference (Keras) 3D U-Net and Isensee2017 weights into the port.

Port of ``fetal_mri_segmentation_tpu/utils/keras_import.py``. The Keras
weight lists (:func:`keras_weight_list_from_model`,
:func:`keras_weight_list_from_h5`) and the layer orders are copies
(``tests/test_torch_copies.py`` holds them equal); the two importers map
onto the same flax-layout numpy tree as the JAX ones, with a plain dict
walk in place of ``jax.tree_util``. :func:`keras_state_dict` builds that
tree from ``utils/params.py::flax_param_shapes`` and turns the result into
the port's ``state_dict`` through ``from_flax``: the port's modules never
see Keras layouts.

Layout facts used (the original's):

- Keras Conv3D kernel: ``(kd, kh, kw, c_in, c_out)``, identical to flax
  ``nn.Conv`` (NDHWC), copied as-is.
- Keras Conv3DTranspose kernel: ``(kd, kh, kw, c_out, c_in)`` with mirrored
  taps: a channel swap and a spatial flip onto flax ``nn.ConvTranspose``.

Weight ordering: the reference's builders create layers in a fixed order
(encoder conv pairs top-down, then per decoder level an up-conv + two
convs, then the 1^3 head); same-type layers are matched in that order, so
the legacy ``.h5`` (build order) and the Keras 3 ``.weights.h5``
(alphabetical) both map. ``keras_weight_list_from_h5`` needs h5py.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from fetal_mri_segmentation_tpu_torch.utils.params import (
    flatten, flax_param_shapes, from_flax, unflatten)


def _as_numpy(tree) -> dict:
    """A nested params tree with numpy leaves (``jax.tree_util.tree_map(
    np.asarray, ...)`` in the original)."""
    return {k: _as_numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in dict(tree).items()}


def keras_weight_list_from_model(keras_model) -> List[Tuple[str, list]]:
    """[(layer_name, [weights...])] for layers that have weights, in build order."""
    out = []
    for layer in keras_model.layers:
        w = layer.get_weights()
        if w:
            out.append((layer.__class__.__name__, w))
    return out


def keras_weight_list_from_h5(path: str) -> List[Tuple[str, list]]:
    """Read a Keras-saved weights HDF5 (legacy ``model_weights`` layout or
    Keras 3 ``.weights.h5`` with ``layers/<name>/vars``) into
    [(layer_name, [weights...])].

    Order caveat: HDF5 group iteration is alphabetical, so same-type layers
    come back in numeric-suffix order (conv3d, conv3d_1, ...) but different
    types are NOT interleaved in build order — `import_keras_unet_weights`
    therefore matches by TYPE QUEUE, not by global position.
    """
    import h5py

    def suffix_index(name: str) -> int:
        tail = name.rsplit("_", 1)[-1]
        return int(tail) if tail.isdigit() else 0

    out = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        if "layer_names" in root.attrs:  # legacy TF1/TF2 format (build order)
            for lname in root.attrs["layer_names"]:
                lname = lname.decode() if isinstance(lname, bytes) else lname
                g = root[lname]
                wnames = [n.decode() if isinstance(n, bytes) else n
                          for n in g.attrs.get("weight_names", [])]
                if wnames:
                    out.append((lname, [np.asarray(g[n]) for n in wnames]))
        elif "layers" in root:  # Keras 3 .weights.h5
            layers_grp = root["layers"]
            names = sorted(layers_grp.keys(),
                           key=lambda n: (n.rstrip("0123456789_"),
                                          suffix_index(n)))
            for lname in names:
                g = layers_grp[lname]
                if "vars" in g and len(g["vars"]):
                    ws = [np.asarray(g["vars"][k])
                          for k in sorted(g["vars"], key=int)]
                    out.append((lname, ws))
        else:
            raise ValueError(f"{path}: unrecognized Keras weights layout")
    return out


def _unet_param_order(params: dict) -> List[str]:
    """Our UNet3D module names in the reference's layer-creation order."""
    enc = sorted(k for k in params if k.startswith("enc"))
    dec = sorted((k for k in params if k.startswith("dec")), reverse=True)

    def level(k):
        return int(k[3])

    order = []
    for lvl in sorted({level(k) for k in enc}):
        order += [f"enc{lvl}_conv1", f"enc{lvl}_conv2"]
    for lvl in sorted({level(k) for k in dec}, reverse=True):
        if f"dec{lvl}_up" in params:
            order.append(f"dec{lvl}_up")
        order += [f"dec{lvl}_conv1", f"dec{lvl}_conv2"]
    order.append("head")
    return [k for k in order if k in params]


def _is_norm(name: str) -> bool:
    return "normalization" in name.lower()


def _is_conv(name: str) -> bool:
    return "conv" in name.lower() and "transpose" not in name.lower()


def _isensee_param_order(params: dict) -> Tuple[List[str], List[str]]:
    """(conv_blocks, seg_heads) — our Isensee2017 module names matching the
    Keras model's weight-layer ordering.

    Reference build order (isensee2017.py::isensee2017_model): per encoder
    level the in-conv then the context module's two conv blocks; per decoder
    level (deep→shallow) the up-sampling module's conv block, the
    localization module's 3^3 then 1^3 conv blocks. The 1^3 segmentation
    heads are created inside the decoder loop but sit at the END of
    ``keras.Model.layers`` (their outputs are only consumed by the final
    deep-supervision sum, so topological depth places them last), in
    creation order = deep→shallow (verified empirically against Keras).
    """
    enc_lv = sorted({int(k[3]) for k in params if k.startswith("enc")})
    dec_lv = sorted({int(k[3]) for k in params if k.startswith("dec")},
                    reverse=True)
    blocks = []
    for lvl in enc_lv:
        blocks += [f"enc{lvl}_in", f"enc{lvl}_ctx1", f"enc{lvl}_ctx2"]
    for lvl in dec_lv:
        blocks += [f"dec{lvl}_up", f"dec{lvl}_loc1", f"dec{lvl}_loc2"]
    heads = [f"seg{lvl}" for lvl in dec_lv if f"seg{lvl}" in params]
    return [k for k in blocks if k in params], heads


def import_keras_isensee_weights(params: dict,
                                 keras_weights: Sequence[Tuple[str, list]]
                                 ) -> dict:
    """Map Keras Isensee2017 weights onto an ``Isensee2017`` params tree.

    Reference: unet3d/training.py::load_old_model restores EITHER
    architecture (custom_objects includes keras-contrib
    InstanceNormalization); this is the Isensee half. Matching uses the
    structural invariant of the reference graph: every conv BLOCK's Conv3D is
    immediately followed by its InstanceNormalization in the weight-layer
    list (nothing weight-bearing sits between them), while the plain 1^3
    segmentation-head convs are the convs NOT followed by a normalization.
    """
    params = _as_numpy(params)
    block_order, head_order = _isensee_param_order(params)

    for name, _ in keras_weights:
        if not (_is_conv(name) or _is_norm(name)):
            raise ValueError(
                f"unexpected weight-bearing keras layer {name!r} — not an "
                f"Isensee2017 graph (conv blocks + segmentation heads only)")

    conv_positions = [i for i, (n, _) in enumerate(keras_weights)
                      if _is_conv(n)]
    norm_positions = [i for i, (n, _) in enumerate(keras_weights)
                      if _is_norm(n)]
    type_grouped = (norm_positions
                    and min(norm_positions) > max(conv_positions))

    blocks_q: List[Tuple[Tuple[str, list], Tuple[str, list]]] = []
    heads_q: List[Tuple[str, list]] = []
    if not type_grouped:
        # model.layers / legacy-h5 order: each block's conv is immediately
        # followed by its normalization; bare convs are segmentation heads.
        i = 0
        while i < len(keras_weights):
            name, w = keras_weights[i]
            if _is_conv(name):
                if (i + 1 < len(keras_weights)
                        and _is_norm(keras_weights[i + 1][0])):
                    blocks_q.append(((name, w), keras_weights[i + 1]))
                    i += 2
                    continue
                heads_q.append((name, w))
            i += 1
    else:
        # Keras-3 .weights.h5 order (keras_weight_list_from_h5 sorts by
        # type, numeric suffix): layer numbering follows model.layers
        # (topological) order, so within the conv type-queue the block convs
        # come first in block order and the bare segmentation heads last —
        # verified empirically against keras.save_weights.
        convs = [keras_weights[i] for i in conv_positions]
        norms = [keras_weights[i] for i in norm_positions]
        blocks_q = list(zip(convs[: len(norms)], norms))
        heads_q = convs[len(norms):]

    if len(blocks_q) != len(block_order) or len(heads_q) != len(head_order):
        raise ValueError(
            f"weight count mismatch: keras has {len(blocks_q)} conv+norm "
            f"blocks and {len(heads_q)} bare segmentation convs, our "
            f"Isensee2017 expects {len(block_order)} blocks and "
            f"{len(head_order)} heads — check depth/n_segmentation_levels, "
            f"or use import_keras_unet_weights for the plain U-Net")

    new = {k: dict(v) for k, v in params.items()}
    for target, ((lname, weights), (nname, nweights)) in zip(block_order,
                                                             blocks_q):
        sub = new[target]
        kernel, bias = weights[0], weights[1]
        want = np.asarray(sub["conv"]["kernel"]).shape
        if kernel.shape != want:
            raise ValueError(
                f"{target}: kernel shape {kernel.shape} != expected {want} "
                f"(keras layer {lname})")
        gamma, beta = nweights[0], nweights[1]
        if gamma.shape != np.asarray(sub["in"]["scale"]).shape:
            raise ValueError(
                f"{target}: InstanceNorm gamma shape {gamma.shape} != "
                f"expected {np.asarray(sub['in']['scale']).shape} "
                f"(keras layer {nname})")
        new[target]["conv"] = {
            "kernel": np.ascontiguousarray(kernel, np.float32),
            "bias": bias.astype(np.float32)}
        new[target]["in"] = {"scale": gamma.astype(np.float32),
                             "bias": beta.astype(np.float32)}
    for target, (lname, weights) in zip(head_order, heads_q):
        kernel, bias = weights[0], weights[1]
        want = np.asarray(new[target]["kernel"]).shape
        if kernel.shape != want:
            raise ValueError(
                f"{target}: kernel shape {kernel.shape} != expected {want} "
                f"(keras layer {lname})")
        new[target] = {"kernel": np.ascontiguousarray(kernel, np.float32),
                       "bias": bias.astype(np.float32)}
    return new


def import_keras_unet_weights(params: dict, keras_weights: Sequence[Tuple[str, list]]
                              ) -> dict:
    """Map Keras conv weights (build order) onto a UNet3D params tree.

    ``params``: the flax params dict (``variables["params"]``). Returns a new
    tree with kernels/biases replaced. Layers without weights (pooling,
    upsampling, concat, activations) must already be absent from
    ``keras_weights``.
    """
    params = _as_numpy(params)
    order = _unet_param_order(params)

    # split the keras layers into type queues (same-type order is reliable
    # both in build order and in alphabetical h5 order).
    if any(_is_norm(n) for n, _ in keras_weights):
        raise ValueError(
            "keras weights contain normalization layers — this plain-UNet "
            "importer maps conv weights only; for the reference's Isensee "
            "architecture use import_keras_isensee_weights")
    transpose_q = [(n, w) for n, w in keras_weights
                   if "transpose" in n.lower()]
    conv_q = [(n, w) for n, w in keras_weights if _is_conv(n)]
    n_deconv = sum(1 for k in order if "deconv" in params.get(k, {}))
    if len(transpose_q) != n_deconv or len(conv_q) != len(order) - n_deconv:
        raise ValueError(
            f"weight count mismatch: keras has {len(conv_q)} conv + "
            f"{len(transpose_q)} transpose layers, our UNet3D expects "
            f"{len(order) - n_deconv} + {n_deconv} ({order}) — check "
            f"depth/deconvolution settings")

    new = {k: dict(v) for k, v in params.items()}
    for target in order:
        sub = new[target]
        if "deconv" in sub:
            lname, weights = transpose_q.pop(0)
            # Keras Conv3DTranspose kernel (k..., out, in) realizes
            # out[s*i+a] += in[i] * K[a, o, c]; flax ConvTranspose
            # (transpose_kernel=False) uses the mirrored taps, so map with a
            # channel swap AND a spatial flip (verified exact in
            # tests/test_keras_import.py).
            kernel = np.transpose(weights[0], (0, 1, 2, 4, 3))[::-1, ::-1, ::-1]
            slot = "deconv"
        else:
            lname, weights = conv_q.pop(0)
            kernel = weights[0]
            slot = None if "kernel" in sub else "conv"
        bias = weights[1]
        want = np.asarray(sub[slot]["kernel"] if slot else sub["kernel"]).shape
        if kernel.shape != want:
            raise ValueError(
                f"{target}: kernel shape {kernel.shape} != expected {want} "
                f"(keras layer {lname})")
        payload = {"kernel": np.ascontiguousarray(kernel, np.float32),
                   "bias": bias.astype(np.float32)}
        new[target] = payload if slot is None else {**sub, slot: payload}
    return new


def keras_params(config, keras_weights: Sequence[Tuple[str, list]]) -> dict:
    """The flax-layout params tree of ``config``'s model (``UNet3D`` or
    ``Isensee2017``) with every leaf taken from ``keras_weights``: the
    importer for the model family over a zero template from
    ``flax_param_shapes`` (every leaf is overwritten, and a graph the
    importers would miss leaves of is refused)."""
    template = unflatten({k: np.zeros(shape, np.float32) for k, shape in
                          flax_param_shapes(config).items()
                          if not k.startswith("batch_stats/")})
    importer = (import_keras_isensee_weights
                if config.model_name == "isensee"
                else import_keras_unet_weights)
    return importer(template, keras_weights)


def keras_state_dict(config, keras_weights: Sequence[Tuple[str, list]]):
    """The port's ``state_dict`` (fp32) for ``config``'s model from a Keras
    weight list: :func:`keras_params` through ``from_flax``."""
    return from_flax(flatten(keras_params(config, keras_weights)))
