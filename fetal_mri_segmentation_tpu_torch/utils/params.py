"""Moving model weights between the JAX package and the port.

The flax variables, flattened with ``/``, hold ``<block>/conv/kernel``
(DHWIO) and ``<block>/conv/bias`` for every conv block, the block's norm
(``<block>/bn/{scale,bias}`` or ``<block>/in/{scale,bias}``), BatchNorm's
running statistics in the ``batch_stats`` collection
(``batch_stats/<block>/bn/{mean,var}``), ``dec{L}_up/deconv/{kernel,bias}``
for a transposed-conv up-sampling (kernel (2, 2, 2, C_in, C_out)) and the
1^3 heads ``head/{kernel,bias}`` (UNet3D) or ``seg{L}/{kernel,bias}``
(Isensee2017). The port keeps the same module names and PyTorch's layouts:
``<block>.conv.weight`` (OIDHW), ``<block>.bn.scale``, the buffers
``<block>.bn.mean`` / ``.var``, ``dec{L}_up.deconv.weight`` (C_in, C_out,
D, H, W), ``head.weight``, ``seg{L}.weight``.

``tools/export_params_npz.py`` writes a trained checkpoint's flattened
params (and ``batch_stats``) with ``np.savez`` where JAX is installed, and
optax's Adam state under ``opt/``; :func:`from_flax` reads the variables
here, and :func:`load_npz_train_state` both (``train --init-params``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_COLLECTIONS = ("params", "batch_stats")
# tools/export_params_npz.py writes optax's Adam state beside the variables:
# opt/mu/<param path>, opt/nu/<param path>, opt/count, opt/learning_rate
OPT_PREFIX = "opt/"
_VECTORS = ("bias", "scale", "mean", "var")


def from_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened flax variables -> the port's ``state_dict`` (fp32).

    A leading ``params/`` or ``batch_stats/`` is dropped (their leaf names
    differ: ``mean`` and ``var`` are BatchNorm's running statistics). A conv
    kernel goes from DHWIO to OIDHW. A transposed-conv kernel (under
    ``deconv``) goes to (C_in, C_out, D, H, W) with its three spatial axes
    flipped: flax's ``ConvTranspose`` does not transpose the kernel, so with
    kernel = stride = 2 it computes ``out[2i + r] = x[i] W[1 - r]`` per
    axis, where ``conv_transpose3d`` computes ``x[i] W[r]``."""
    state = {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] in _COLLECTIONS:
            parts = parts[1:]
        arr = np.array(value, dtype=np.float32)  # a writable copy
        if parts[-1] == "kernel":
            if arr.ndim != 5:
                raise ValueError(f"{path}: expected a 5-D DHWIO kernel, got "
                                 f"shape {arr.shape}")
            parts[-1] = "weight"
            if len(parts) > 1 and parts[-2] == "deconv":
                arr = arr[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
            else:
                arr = arr.transpose(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
        elif parts[-1] not in _VECTORS:
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


def load_npz_train_state(state, path: str) -> bool:
    """Start ``state`` (a ``training.state.TrainState``) from an exported
    ``.npz``: the variables into the model and, where the file holds them
    (``opt/mu/...``, ``opt/nu/...``, ``opt/count``, ``opt/learning_rate``),
    optax's Adam moments, step count and learning rate into the optimizer.
    Returns whether the file held the Adam state."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    state.model.load_state_dict(from_flax(
        {k: v for k, v in flat.items() if not k.startswith(OPT_PREFIX)}))
    mu = {k[len(OPT_PREFIX) + 3:]: v for k, v in flat.items()
          if k.startswith(OPT_PREFIX + "mu/")}
    if not mu:
        return False
    nu = {k[len(OPT_PREFIX) + 3:]: v for k, v in flat.items()
          if k.startswith(OPT_PREFIX + "nu/")}
    count = int(flat[OPT_PREFIX + "count"])
    load_optax_adam_state(state.optimizer, state.model, count, mu, nu,
                          float(flat[OPT_PREFIX + "learning_rate"]))
    state.step = count
    return True


def flax_param_shapes(config) -> Dict[str, tuple]:
    """Shapes of the flax variables of ``config``'s model (``UNet3D`` or
    ``Isensee2017``), flattened, in the order the model creates them:
    params without a prefix, BatchNorm's running statistics under
    ``batch_stats/``."""
    shapes = {}

    def block(name, cin, cout, k=3, norm=None):
        shapes[f"{name}/conv/kernel"] = (k, k, k, cin, cout)
        shapes[f"{name}/conv/bias"] = (cout,)
        if norm:
            shapes[f"{name}/{norm}/scale"] = (cout,)
            shapes[f"{name}/{norm}/bias"] = (cout,)
        if norm == "bn":
            shapes[f"batch_stats/{name}/bn/mean"] = (cout,)
            shapes[f"batch_stats/{name}/bn/var"] = (cout,)

    def head(name, cin):
        shapes[f"{name}/kernel"] = (1, 1, 1, cin, config.n_labels)
        shapes[f"{name}/bias"] = (config.n_labels,)

    cin = config.nb_channels
    if config.model_name == "isensee":
        filters = [config.n_base_filters * 2 ** level
                   for level in range(config.depth)]
        for level, f in enumerate(filters):
            block(f"enc{level}_in", cin, f, norm="in")
            block(f"enc{level}_ctx1", f, f, norm="in")
            block(f"enc{level}_ctx2", f, f, norm="in")
            cin = f
        for level in range(config.depth - 2, -1, -1):
            f = filters[level]
            block(f"dec{level}_up", cin, f, norm="in")
            block(f"dec{level}_loc1", 2 * f, f, norm="in")
            block(f"dec{level}_loc2", f, f, k=1, norm="in")
            if level < config.n_segmentation_levels:
                head(f"seg{level}", f)
            cin = f
        return shapes

    norm = ("bn" if config.batch_normalization else
            "in" if config.instance_normalization else None)
    for level in range(config.depth):
        f = config.n_base_filters * 2 ** level
        block(f"enc{level}_conv1", cin, f, norm=norm)
        block(f"enc{level}_conv2", f, 2 * f, norm=norm)
        cin = 2 * f
    for level in range(config.depth - 2, -1, -1):
        skip = 2 * config.n_base_filters * 2 ** level
        if config.deconvolution:
            shapes[f"dec{level}_up/deconv/kernel"] = (2, 2, 2, cin, cin)
            shapes[f"dec{level}_up/deconv/bias"] = (cin,)
        block(f"dec{level}_conv1", cin + skip, skip, norm=norm)
        block(f"dec{level}_conv2", skip, skip, norm=norm)
        cin = skip
    head("head", cin)
    return shapes


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2
    return z


def init_flax_like(config, seed: int = 0) -> Dict[str, np.ndarray]:
    """Fresh flattened flax variables drawn with numpy: lecun-normal
    kernels (truncated to 2 sigma, flax's variance_scaling(1, "fan_in",
    "truncated_normal")), zero biases, unit norm scales, and BatchNorm's
    running mean 0 and variance 1, as the flax modules initialize. Same
    keys and shapes as ``model.init`` (:func:`flax_param_shapes`); not the
    same random bits. Runs without JAX."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, shape in flax_param_shapes(config).items():
        if path.endswith("kernel"):
            fan_in = int(np.prod(shape[:-1]))
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            flat[path] = (_truncated_normal(rng, shape) * std).astype(
                np.float32)
        elif path.endswith(("scale", "var")):
            flat[path] = np.ones(shape, np.float32)
        else:
            flat[path] = np.zeros(shape, np.float32)
    return flat
