#!/usr/bin/env python
"""Export a trained checkpoint's variables for the PyTorch port.

    python tools/export_params_npz.py --config my_experiment.json \
        [--out params.npz]

Runs where JAX is installed: restores ``config.model_file`` with
``fetal_mri_segmentation_tpu.inference.predict.load_serving_model`` and
writes the flax params, flattened with "/" (``enc0_conv1/conv/kernel``, ...),
and a BatchNorm model's running statistics under ``batch_stats/``
(``batch_stats/enc0_conv1/bn/mean``, ...), with ``np.savez``. The
checkpoint's optax Adam state goes in beside them: ``opt/mu/<param path>``,
``opt/nu/<param path>``, ``opt/count`` and ``opt/learning_rate``. The port
reads the file with
``fetal_mri_segmentation_tpu_torch.inference.predict.load_serving_model``
(the variables only), as ``--params`` of ``python -m
fetal_mri_segmentation_tpu_torch.predict``, or as ``--init-params`` of
``python -m fetal_mri_segmentation_tpu_torch.train``, which continues
training from the weights and the Adam moments. This file stands in for a
reader of the orbax checkpoint, which the port does not have.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def adam_state(opt_state):
    """The ``optax.ScaleByAdamState`` inside ``opt_state`` (the
    ``inject_hyperparams`` state of the JAX package's ``make_optimizer``,
    whose chain may start with a global-norm clip)."""
    import optax

    for part in opt_state.inner_state:
        if isinstance(part, optax.ScaleByAdamState):
            return part
    raise ValueError("no ScaleByAdamState in the optimizer state")


def flatten_state(state) -> dict:
    """A JAX ``TrainState`` as the flat name -> array mapping of the file:
    params, ``batch_stats/...`` and the Adam state under ``opt/``."""
    from flax.traverse_util import flatten_dict

    flat = dict(flatten_dict(state.params, sep="/"))
    flat.update({f"batch_stats/{key}": value for key, value in flatten_dict(
        state.batch_stats or {}, sep="/").items()})
    adam = adam_state(state.opt_state)
    for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
        flat.update({f"opt/{name}/{key}": value
                     for key, value in flatten_dict(tree, sep="/").items()})
    flat["opt/count"] = np.asarray(adam.count, np.int64)
    flat["opt/learning_rate"] = np.asarray(
        state.opt_state.hyperparams["learning_rate"], np.float64)
    return {key: np.asarray(value) for key, value in flat.items()}


def export_params(config, out: str) -> int:
    """Write ``config.model_file``'s params, ``batch_stats`` and Adam state
    to ``out``; returns the number of model variables written (params and
    ``batch_stats``; the ``opt/`` arrays are not counted)."""
    from fetal_mri_segmentation_tpu.models import build_model
    from fetal_mri_segmentation_tpu.training.checkpoint import load_old_model

    state, _, _ = load_old_model(config.model_file, build_model(config),
                                 config)
    flat = flatten_state(state)
    np.savez(out, **flat)
    return sum(not key.startswith("opt/") for key in flat)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True, help="experiment JSON")
    ap.add_argument("--out", default="params.npz")
    args = ap.parse_args()

    from fetal_mri_segmentation_tpu.config import Config

    n = export_params(Config.load(args.config), args.out)
    print(f"wrote {n} variables and the Adam state to {args.out}")
