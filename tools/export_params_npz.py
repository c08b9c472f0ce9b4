#!/usr/bin/env python
"""Export a trained checkpoint's variables for the PyTorch port.

    python tools/export_params_npz.py --config my_experiment.json \
        [--out params.npz]

Runs where JAX is installed: restores ``config.model_file`` with
``fetal_mri_segmentation_tpu.inference.predict.load_serving_model`` and
writes the flax params, flattened with "/" (``enc0_conv1/conv/kernel``, ...),
and a BatchNorm model's running statistics under ``batch_stats/``
(``batch_stats/enc0_conv1/bn/mean``, ...), with ``np.savez``. The port
reads the file with
``fetal_mri_segmentation_tpu_torch.inference.predict.load_serving_model``,
or as ``--params`` of ``python -m fetal_mri_segmentation_tpu_torch.predict``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def export_params(config, out: str) -> int:
    """Write ``config.model_file``'s params (and ``batch_stats``) to
    ``out``; returns the number of arrays written."""
    from flax.traverse_util import flatten_dict

    from fetal_mri_segmentation_tpu.inference.predict import (
        load_serving_model)

    _, variables = load_serving_model(config)
    flat = flatten_dict(variables["params"], sep="/")
    flat.update({f"batch_stats/{key}": value for key, value in flatten_dict(
        variables.get("batch_stats", {}), sep="/").items()})
    np.savez(out, **{key: np.asarray(value) for key, value in flat.items()})
    return len(flat)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True, help="experiment JSON")
    ap.add_argument("--out", default="params.npz")
    args = ap.parse_args()

    from fetal_mri_segmentation_tpu.config import Config

    n = export_params(Config.load(args.config), args.out)
    print(f"wrote {n} arrays to {args.out}")
