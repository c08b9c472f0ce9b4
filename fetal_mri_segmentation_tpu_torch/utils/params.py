"""Moving UNet3D weights between the JAX package and the port.

The flax tree, flattened with ``/``, holds ``<block>/conv/kernel`` (DHWIO)
and ``<block>/conv/bias`` for every 3^3 conv block and ``head/kernel``
(1, 1, 1, C, L) / ``head/bias`` for the 1^3 head
(``models/layers.py::_ConvParams``, ``nn.Conv``). The port keeps the same
block names and PyTorch's OIDHW weight layout: ``<block>.conv.weight``,
``<block>.conv.bias``, ``head.weight``, ``head.bias``.

``tools/export_params_npz.py`` writes a trained checkpoint's flattened tree
with ``np.savez`` where JAX is installed; :func:`from_flax` reads it here.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def from_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened flax params -> the port's ``state_dict`` (fp32 tensors).

    A leading ``params/`` is dropped; any other collection (BatchNorm's
    ``batch_stats``) has no counterpart in the port and raises."""
    state = {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        elif parts[0] == "batch_stats":
            raise NotImplementedError(
                "batch_stats: conv-block norms are not ported yet "
                "(ROADMAP.md queue 1, item 2)")
        arr = np.array(value, dtype=np.float32)  # a writable copy
        if parts[-1] == "kernel":
            if arr.ndim != 5:
                raise ValueError(f"{path}: expected a 5-D DHWIO kernel, got "
                                 f"shape {arr.shape}")
            parts[-1] = "weight"
            arr = arr.transpose(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
        elif parts[-1] != "bias":
            raise ValueError(f"{path}: unknown parameter {parts[-1]!r}")
        state[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def load_optax_adam_state(optimizer, model, count: int,
                          mu: Mapping[str, np.ndarray],
                          nu: Mapping[str, np.ndarray],
                          learning_rate: float) -> None:
    """Carry an optax ``ScaleByAdamState`` over to ``optimizer`` (a
    ``training.state.KerasAdam`` over ``model.parameters()``), as
    :func:`from_flax` carries the weights.

    ``mu`` and ``nu`` are the moments as flattened flax trees (the params'
    paths, DHWIO kernels), ``count`` the step count and ``learning_rate``
    the optimizer's ``hyperparams["learning_rate"]``."""
    moments = from_flax(mu), from_flax(nu)
    params = dict(model.named_parameters())
    for tree in moments:
        if set(tree) != set(params):
            raise ValueError(
                f"optimizer moments name {sorted(set(tree) ^ set(params))} "
                "that the model lacks or misses")
    for name, p in params.items():
        optimizer.state[p] = {
            "count": int(count),
            "mu": moments[0][name].to(device=p.device, dtype=p.dtype),
            "nu": moments[1][name].to(device=p.device, dtype=p.dtype)}
    optimizer.set_learning_rate(float(learning_rate))


def flax_param_shapes(config) -> Dict[str, tuple]:
    """Shapes of the flax ``UNet3D`` param tree for ``config``, flattened,
    in the order the model creates them."""
    shapes = {}

    def block(name, cin, cout):
        shapes[f"{name}/conv/kernel"] = (3, 3, 3, cin, cout)
        shapes[f"{name}/conv/bias"] = (cout,)

    cin = config.nb_channels
    for level in range(config.depth):
        f = config.n_base_filters * 2 ** level
        block(f"enc{level}_conv1", cin, f)
        block(f"enc{level}_conv2", f, 2 * f)
        cin = 2 * f
    for level in range(config.depth - 2, -1, -1):
        skip = 2 * config.n_base_filters * 2 ** level
        block(f"dec{level}_conv1", cin + skip, skip)
        block(f"dec{level}_conv2", skip, skip)
        cin = skip
    shapes["head/kernel"] = (1, 1, 1, cin, config.n_labels)
    shapes["head/bias"] = (config.n_labels,)
    return shapes


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2
    return z


def init_flax_like(config, seed: int = 0) -> Dict[str, np.ndarray]:
    """A fresh flattened flax param tree drawn with numpy: lecun-normal
    kernels (truncated to 2 sigma, flax's variance_scaling(1, "fan_in",
    "truncated_normal")) and zero biases, as ``_ConvParams`` and
    ``nn.Conv`` initialize. Same keys and shapes as ``UNet3D.init``; not
    the same random bits. Runs without JAX."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, shape in flax_param_shapes(config).items():
        if path.endswith("kernel"):
            fan_in = int(np.prod(shape[:-1]))
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            flat[path] = (_truncated_normal(rng, shape) * std).astype(
                np.float32)
        else:
            flat[path] = np.zeros(shape, np.float32)
    return flat
